"""The port's inspect CLI (``python -m torchsnapshot_tpu_torch.inspect``),
the cases of tests/test_inspect_cli.py and the CLI cases of
test_integrity.py, test_copy_to.py and test_incremental.py: for the same
snapshot, taken by either package, its lines are the JAX package's
(listing, ``--raw``, ``--rank``, ``--verify``, ``--diff``, ``--steps``,
``--reconcile``, ``--convert-back``), and its exit codes too, and the
telemetry flags (``--report``, ``--doctor``, ``--timeline``) agree with
the JAX package's on snapshots either package took."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.inspect import main as jax_main
from torchsnapshot_tpu.utils.test_utils import run_thread_ranks as jax_thread_ranks
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict
from torchsnapshot_tpu_torch.inspect import main
from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Model:
    def __init__(self, params):
        self.params = params

    def state_dict(self):
        return self.params

    def load_state_dict(self, sd):
        self.params = sd


def _golden(kind):
    conv = torch.from_numpy if kind == "port" else jnp.asarray
    model = _Model({
        "w": conv(np.arange(48, dtype=np.float32).reshape(8, 6)),
        "b": conv(np.zeros(6, np.float32)),
        "meta": {"name": "golden"},
        "tags": {"x"},
    })
    progress = (StateDict if kind == "port" else jsnap.StateDict)(step=7, done=False)
    return {"model": model, "progress": progress}


def _take(kind, path, app=None, **kwargs):
    pkg = Snapshot if kind == "port" else jsnap.Snapshot
    return pkg.take(path, app if app is not None else _golden(kind), **kwargs)


def _both(capsys, argv):
    """(exit code, stdout) of the port's CLI and of the JAX package's."""
    rc = main(list(argv))
    out = capsys.readouterr().out
    jrc = jax_main(list(argv))
    jout = capsys.readouterr().out
    return (rc, out), (jrc, jout)


GOLDEN_DEFAULT = """\
model                                                        <dict>
model/b                                                      Array float32(6,) 24B @ 0/model/b
model/meta                                                   <dict>
model/meta/name                                              str = 'golden'
model/tags                                                   object @ 0/model/tags
model/w                                                      Array float32(8, 6) 192B @ 0/model/w
progress                                                     <dict>
progress/done                                                bool = False
progress/step                                                int = 7

9 entries, 216B of array data
"""


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_default_and_raw_listings_are_the_jax_lines(tmp_path, capsys, writer):
    path = str(tmp_path / "snap")
    _take(writer, path)
    port, ref = _both(capsys, [path])
    assert port == ref == (0, GOLDEN_DEFAULT)
    port, ref = _both(capsys, [path, "--raw"])
    assert port == ref and port[1].startswith("0/model ") and "9 entries, 216B" in port[1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rank_selects_per_rank_view(tmp_path, capsys, writer):
    """--rank N shows rank N's values of a world-2 snapshot."""
    path = str(tmp_path / "snap")

    def take(coord, rank):
        w = np.full(4 + rank, float(rank), np.float32)
        value = torch.from_numpy(w) if writer == "port" else w
        _take(writer, path, {"model": _Model({"w": value, "shared": np.ones(3, np.float32)})},
              coord=coord, replicated=["model/shared"])

    (run_thread_ranks if writer == "port" else jax_thread_ranks)(2, take)
    outs = []
    for rank in ("0", "1"):
        port, ref = _both(capsys, [path, "--rank", rank])
        assert port == ref
        outs.append(port[1])
    assert "float32(4,)" in outs[0] and "@ 0/model/w" in outs[0]
    assert "float32(5,)" in outs[1] and "@ 1/model/w" in outs[1]
    assert "replicated @ replicated/model/shared" in outs[1]
    port, ref = _both(capsys, [path, "--raw"])
    assert port == ref


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_verify_lines_and_exit_codes(tmp_path, capsys, writer):
    path = str(tmp_path / "snap")
    _take(writer, path)
    port, ref = _both(capsys, [path, "--verify"])
    assert port == ref and port[0] == 0 and "OK" in port[1]
    w = os.path.join(path, "0", "model", "w")
    data = bytearray(open(w, "rb").read())
    data[0] ^= 0xFF
    open(w, "wb").write(bytes(data))
    port, ref = _both(capsys, [path, "--verify"])
    assert port == ref and port[0] == 1 and port[1].startswith("BAD 0/model/w: Checksum mismatch")


def test_diff_lines_and_exit_codes(tmp_path, capsys):
    """Changed → 1; identical → 0; inconclusive (checksums of differing
    compression, no fingerprints) → 3, distinct from argparse's 2."""
    w = np.arange(32, dtype=np.float32)
    Snapshot.take(str(tmp_path / "s1"), {"model": StateDict(w=torch.from_numpy(w.copy()))},
                  fingerprint=True)
    jsnap.Snapshot.take(str(tmp_path / "s2"), {"model": jsnap.StateDict(w=jnp.asarray(w * 2))},
                        fingerprint=True)
    port, ref = _both(capsys, [str(tmp_path / "s2"), "--diff", str(tmp_path / "s1")])
    assert port == ref and port[0] == 1
    assert port[1] == "  changed  model/w\n0 added, 0 removed, 1 changed, 0 unchanged, 0 unknown\n"
    port, ref = _both(capsys, [str(tmp_path / "s1"), "--diff", str(tmp_path / "s1")])
    assert port == ref and port[0] == 0
    ones = np.ones(64, np.float32)
    Snapshot.take(str(tmp_path / "o1"), {"model": StateDict(w=torch.from_numpy(ones))})
    jsnap.Snapshot.take(str(tmp_path / "o2"), {"model": jsnap.StateDict(w=jnp.asarray(ones))},
                        compression="zlib")
    port, ref = _both(capsys, [str(tmp_path / "o2"), "--diff", str(tmp_path / "o1")])
    assert port == ref and port[0] == 3


def _mgr_state(value):
    return {"s": StateDict(w=torch.full((8,), float(value)))}


def test_steps_and_reconcile(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    base = str(tmp_path / "run")
    assert main([base, "--steps"]) == jax_main([base, "--steps"]) == 1
    assert "no committed steps" in capsys.readouterr().err
    mgr = CheckpointManager(base)
    mgr.save(1, _mgr_state(1))
    mgr.save(2, _mgr_state(2))
    port, ref = _both(capsys, [base, "--steps"])
    assert port == ref == (0, "1\n2\n")
    # An async save whose wait() never ran its finalize: committed, no marker.
    Snapshot.async_take(f"{base}/step-3", _mgr_state(3)).wait()
    assert main([base, "--reconcile", "adopt"]) == 0
    assert capsys.readouterr().out == "3\n"
    port, ref = _both(capsys, [base, "--steps"])
    assert port == ref == (0, "1\n2\n3\n")
    Snapshot.async_take(f"{base}/step-4", _mgr_state(4)).wait()
    assert main([base, "--reconcile", "sweep"]) == 0
    assert capsys.readouterr().out == "4\n"
    assert not os.path.exists(f"{base}/step-4/.snapshot_metadata")


def test_copy_to_and_delete(tmp_path, capsys):
    w = np.arange(16, dtype=np.float32)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    jsnap.Snapshot.take(src, {"m": jsnap.StateDict(w=jnp.asarray(w))})
    assert main([src, "--copy-to", dst]) == 0
    assert "copied" in capsys.readouterr().out
    target = StateDict(w=torch.zeros(16))
    Snapshot(dst).restore({"m": target})
    assert target["w"].numpy().tobytes() == w.tobytes()
    assert main([src, "--delete"]) == 0
    assert capsys.readouterr().out == f"deleted {src}\n"
    assert not os.path.exists(os.path.join(src, ".snapshot_metadata"))
    with pytest.raises(SystemExit):
        main([dst, "--sweep"])  # --sweep requires --delete


@pytest.mark.parametrize("flags", [
    ["--verify", "--delete"], ["--verify", "--diff", "x"], ["--copy-to", "x", "--steps"],
    ["--report", "--verify"], ["--reconcile", "adopt", "--sweep"],
])
def test_modes_are_mutually_exclusive(tmp_path, flags):
    path = str(tmp_path / "snap")
    _take("port", path)
    for cli in (main, jax_main):
        with pytest.raises(SystemExit) as e:
            cli([path] + flags)
        assert e.value.code == 2


@pytest.mark.parametrize("flags, flag", [
    (["--report"], "report"), (["--doctor"], "doctor"), (["--timeline"], "timeline"),
])
def test_flags_of_unported_modules_exit_nonzero_naming_their_item(tmp_path, capsys, flags, flag):
    """The telemetry flags on snapshots either package took: both CLIs
    give the same exit code, 0 or 1, and each prints its rendering (the
    report's title, the doctor's verdict, the timeline's table) to
    stdout. The name is the one this test had while the flags were
    stubs that exited 2 naming their ROADMAP item."""
    for writer in ("port", "jax"):
        path = str(tmp_path / f"snap_{writer}")
        _take(writer, path)
        (rc, out), (jrc, jout) = _both(capsys, [path] + flags)
        assert rc == jrc, (writer, flag, out, jout)
        assert rc in (0, 1) and out.strip() and jout.strip()
        if flag == "report":
            assert rc == 0 and "take" in out and f"{path}" in out
            assert out.splitlines()[0] == jout.splitlines()[0]
        if flag == "timeline":
            assert "sentinel" in out and out.splitlines()[0] == jout.splitlines()[0]


def test_convert_back_exports_a_snapshot_the_jax_reader_restores(tmp_path, capsys):
    """--convert-back prints the JAX CLI's line and writes the reference
    format: the JAX package's ReferenceSnapshotReader restores it."""
    from torchsnapshot_tpu.interop import ReferenceSnapshotReader

    path, dest = str(tmp_path / "snap"), str(tmp_path / "ref")
    _take("port", path)
    assert main([path, "--convert-back", dest]) == 0
    assert capsys.readouterr().out == f"exported {path} -> {dest} (reference format)\n"
    assert jax_main([path, "--convert-back", str(tmp_path / "jax_ref")]) == 0
    assert capsys.readouterr().out == f"exported {path} -> {tmp_path / 'jax_ref'} (reference format)\n"
    template = _Model({"w": np.zeros((8, 6), np.float32), "b": np.ones(6, np.float32),
                       "meta": {"name": ""}, "tags": set()})
    progress = jsnap.StateDict(step=0, done=True)
    ReferenceSnapshotReader(dest).restore({"model": template, "progress": progress})
    assert template.params["w"].tobytes() == np.arange(48, dtype=np.float32).tobytes()
    assert template.params["b"].tobytes() == np.zeros(6, np.float32).tobytes()
    assert template.params["meta"] == {"name": "golden"} and template.params["tags"] == {"x"}
    assert progress["step"] == 7 and progress["done"] is False


def test_runs_as_a_module(tmp_path):
    path = str(tmp_path / "snap")
    _take("jax", path)
    proc = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.inspect", path, "--verify"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
