"""Partial restores (``restore(paths=...)``) and container reads of the
port, the cases of tests/test_partial_restore.py, held against the JAX
package: for a snapshot taken by either package, a filtered restore
through each package changes the same leaves to the same bytes, and both
raise where one does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin


class _Holder:
    """A stateful of either package: a state dict held as is."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = sd


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "w0": rng.standard_normal(8).astype(np.float32),
        "w1": rng.standard_normal(8).astype(np.float32),
        "head": rng.standard_normal(4).astype(np.float32),
        "mu": rng.standard_normal(8).astype(np.float32),
    }


def _app(kind, arrays=None, step=7):
    """The app state as ``kind`` ("port": torch tensors, "jax": jax arrays)
    holds it; zero arrays and step -1 without ``arrays``."""
    a = arrays or {k: np.zeros_like(v) for k, v in _arrays().items()}
    conv = torch.from_numpy if kind == "port" else jnp.asarray
    return {
        "model": _Holder({"layers": {"w0": conv(a["w0"].copy()), "w1": conv(a["w1"].copy())},
                          "head": conv(a["head"].copy())}),
        "optim": _Holder({"mu": conv(a["mu"].copy()), "step": step if arrays else -1}),
    }


def _as_np(app):
    m, o = app["model"].sd, app["optim"].sd
    return {
        "w0": np.asarray(m["layers"]["w0"]), "w1": np.asarray(m["layers"]["w1"]),
        "head": np.asarray(m["head"]), "mu": np.asarray(o["mu"]), "step": o["step"],
    }


@pytest.fixture(params=["port", "jax"])
def snap_path(request, tmp_path):
    path = str(tmp_path / "snap")
    pkg = Snapshot if request.param == "port" else jsnap.Snapshot
    pkg.take(path, _app(request.param, _arrays()))
    return path


def _restore_both(path, paths):
    """The filtered restore through each package into zero templates;
    the two results as numpy, after checking they are equal."""
    port, jax_app = _app("port"), _app("jax")
    Snapshot(path).restore(port, paths=paths)
    jsnap.Snapshot(path).restore(jax_app, paths=paths)
    got, ref = _as_np(port), _as_np(jax_app)
    for k in got:
        assert np.asarray(got[k]).tobytes() == np.asarray(ref[k]).tobytes(), k
    return got


def test_partial_restore_glob(snap_path):
    got, a = _restore_both(snap_path, ["model/layers/**"]), _arrays()
    assert got["w0"].tobytes() == a["w0"].tobytes() and got["w1"].tobytes() == a["w1"].tobytes()
    assert not got["head"].any() and not got["mu"].any() and got["step"] == -1


def test_partial_restore_whole_stateful(snap_path):
    got, a = _restore_both(snap_path, ["optim/**"]), _arrays()
    assert got["step"] == 7 and got["mu"].tobytes() == a["mu"].tobytes()
    assert not got["w0"].any() and not got["head"].any()


def test_partial_restore_missing_selected_path_still_errors(snap_path):
    for pkg, conv in ((Snapshot, torch.zeros), (jsnap.Snapshot, jnp.zeros)):
        target = {"model": _Holder({"layers": {"nonexistent": conv(3)}})}
        with pytest.raises(RuntimeError, match="Unable to find an entry"):
            pkg(snap_path).restore(target, paths=["model/**"])


def test_partial_restore_filter_excludes_missing_path(snap_path):
    results = []
    for pkg, conv in ((Snapshot, torch.zeros), (jsnap.Snapshot, jnp.zeros)):
        target = {"model": _Holder({"layers": {"w0": conv(8), "w1": conv(8), "nonexistent": conv(3)},
                                    "head": conv(4)})}
        pkg(snap_path).restore(target, paths=["model/head"])
        results.append(np.asarray(target["model"].sd["head"]).tobytes())
        assert not np.asarray(target["model"].sd["layers"]["w0"]).any()
    assert results == [_arrays()["head"].tobytes()] * 2


def test_partial_restore_no_match_raises(snap_path):
    for pkg, kind in ((Snapshot, "port"), (jsnap.Snapshot, "jax")):
        with pytest.raises(RuntimeError, match="matched no leaf"):
            pkg(snap_path).restore(_app(kind), paths=["Model/**"])  # a typo'd case


def test_read_object_container(snap_path):
    layers = Snapshot(snap_path).read_object("model/layers")
    ref = jsnap.Snapshot(snap_path).read_object("model/layers")
    assert set(layers) == set(ref) == {"w0", "w1"}
    for k in layers:
        assert layers[k].numpy().tobytes() == np.asarray(ref[k]).tobytes() == _arrays()[k].tobytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_read_object_container_with_primitives_and_objects(tmp_path, writer):
    path = str(tmp_path / "snap")
    pkg = Snapshot if writer == "port" else jsnap.Snapshot
    sd = (StateDict if writer == "port" else jsnap.StateDict)(
        epoch=3, name="run-a", nested={"xs": [1, 2, 3], "arr": np.arange(5.0)}, tags={"a", "b"},
    )
    pkg.take(path, {"st": sd})
    nested = Snapshot(path).read_object("st/nested")
    assert nested["xs"] == jsnap.Snapshot(path).read_object("st/nested")["xs"] == [1, 2, 3]
    assert np.asarray(nested["arr"]).tobytes() == np.arange(5.0).tobytes()
    whole = Snapshot(path).read_object("st")
    assert (whole["epoch"], whole["name"], whole["tags"]) == (3, "run-a", {"a", "b"})


def test_read_object_container_rejects_template(snap_path):
    with pytest.raises(ValueError, match="container"):
        Snapshot(snap_path).read_object("model/layers", template=torch.zeros(8))


def test_partial_restore_leaves_unselected_tensors_untouched_and_reads_only_selected(
    snap_path, monkeypatch
):
    """The unselected leaves keep their tensors and bytes, and the
    restore reads the selected leaves' objects and nothing else."""
    reads = []
    real = FSStoragePlugin.read

    async def spy(self, io_req):
        reads.append(io_req.path)
        await real(self, io_req)

    monkeypatch.setattr(FSStoragePlugin, "read", spy)
    app = _app("port")
    head, mu = app["model"].sd["head"], app["optim"].sd["mu"]
    head.fill_(3.0)
    snap = Snapshot(snap_path)
    snap.restore(app, paths=["model/layers/w1", "optim/step"])
    # Beside the selected leaf's object, the metadata and the telemetry
    # ledger (its restore record appends to it) are read, as in the JAX
    # package.
    assert sorted(reads) == [".snapshot_metadata", ".telemetry/ledger.jsonl", "0/model/layers/w1"]
    assert app["model"].sd["head"] is head and torch.equal(head, torch.full((4,), 3.0))
    assert app["optim"].sd["mu"] is mu and not mu.any()
    assert app["optim"].sd["step"] == 7
    assert app["model"].sd["layers"]["w1"].numpy().tobytes() == _arrays()["w1"].tobytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_partial_restore_with_verify_device_checks_only_the_selected_leaves(tmp_path, writer):
    path = str(tmp_path / "snap")
    pkg = Snapshot if writer == "port" else jsnap.Snapshot
    pkg.take(path, _app(writer, _arrays()), fingerprint=True)
    app = _app("port")
    Snapshot(path).restore(app, paths=["model/layers/**"], verify_device=True)
    assert snapshot_mod._last_verify_stats == {"verified": 2, "skipped": 0}
    assert app["model"].sd["layers"]["w0"].numpy().tobytes() == _arrays()["w0"].tobytes()


@pytest.mark.parametrize("pkg_name", ["port", "jax"])
def test_invalidate_caches_rereads_a_retaken_path(tmp_path, pkg_name):
    """A handle keeps its metadata until invalidate_caches() (delete calls
    it); a new handle reads afresh. The same in both packages."""
    path = str(tmp_path / "snap")
    pkg = Snapshot if pkg_name == "port" else jsnap.Snapshot
    Snapshot.take(path, {"m": StateDict(w=torch.zeros(4))})
    handle = pkg(path)
    assert handle.get_manifest()["0/m/w"].shape == [4]
    Snapshot.take(path, {"m": StateDict(w=torch.zeros(8))})  # re-taken from elsewhere
    assert handle.get_manifest()["0/m/w"].shape == [4]
    assert pkg(path).get_manifest()["0/m/w"].shape == [8]
    handle.invalidate_caches()
    assert handle.get_manifest()["0/m/w"].shape == [8]
    assert handle.read_object("m/w").shape == (8,)
