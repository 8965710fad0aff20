"""The port's ledger, timeline and SLO engine against the JAX package's:
``encode_line`` is byte-equal, a ledger either package wrote is read by
the other's ``read_records``, a torn tail and rotation behave the same,
``timeline`` and ``slo.evaluate`` give equal output on the same records,
and ``inspect --timeline`` agrees on a manager root either package
saved to."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.inspect import main as jax_inspect
from torchsnapshot_tpu.telemetry import ledger as jax_ledger
from torchsnapshot_tpu.telemetry import slo as jax_slo
from torchsnapshot_tpu.telemetry import timeline as jax_timeline
from torchsnapshot_tpu_torch import CheckpointManager, StateDict
from torchsnapshot_tpu_torch.inspect import main as port_inspect
from torchsnapshot_tpu_torch.telemetry import ledger, slo, timeline


def _records(n=24, seed=2):
    """Take and restore digests with a seeded spread (one late regression)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        wall = float(rng.uniform(9, 11)) * (3.0 if i == n - 1 else 1.0)
        nbytes = int(rng.integers(1 << 30, 2 << 30))
        out.append({
            "format_version": 1, "kind": "take" if i % 4 else "restore",
            "step": i, "take_id": f"{i:032x}", "world_size": 2, "ts": 1.7e9 + 60 * i,
            "wall_s": wall, "bytes": nbytes, "gbps": nbytes / (1 << 30) / wall,
            "stall_pct": float(rng.uniform(0, 5)), "retries": int(rng.integers(0, 3)),
            "churn": {"added_bytes": nbytes, "unchanged_bytes": 0, "efficiency": 0.0},
            "goodput": {"checkpoint_overhead_pct": float(rng.uniform(0, 8))},
            "doctor": ["retry-storm"] if i == 5 else [],
        })
    return out


def test_encode_and_decode_line_are_byte_equal():
    for record in _records() + [{"k": "ü", "n": None, "x": [1.5, {"y": True}]}]:
        line = ledger.encode_line(record)
        assert line == jax_ledger.encode_line(record)
        assert ledger.decode_line(line) == jax_ledger.decode_line(line) == record
    assert ledger.decode_line("{not json") is None and jax_ledger.decode_line("{not json") is None


def _write(mod, root, records):
    for r in records:
        mod.append_for_snapshot(os.path.join(root, f"step-{r['step']}"), r)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_ledger_either_package_wrote_reads_in_both(tmp_path, writer):
    root = str(tmp_path)
    records = _records(8)
    _write(ledger if writer == "port" else jax_ledger, root, records)
    got, skipped = ledger.read_records(root)
    want, jskipped = jax_ledger.read_records(root)
    assert got == want and skipped == jskipped == 0
    assert [r["step"] for r in got] == [r["step"] for r in records]
    assert ledger.ledger_root_for(f"{root}/step-7") == jax_ledger.ledger_root_for(f"{root}/step-7") == (root, 7)


def test_torn_tail_and_rotation_behave_the_same(tmp_path, monkeypatch):
    records = _records(12)
    roots = {}
    for name, mod in (("port", ledger), ("jax", jax_ledger)):
        root = str(tmp_path / name)
        _write(mod, root, records[:4])
        with open(os.path.join(root, ".telemetry", "ledger.jsonl"), "ab") as f:
            f.write(b'{"crc":"0000","record":{"torn"')  # an append cut mid-line
        raw = open(os.path.join(root, ".telemetry", "ledger.jsonl"), "rb").read()
        assert mod.parse_ledger_bytes(raw)[1:] == jax_ledger.parse_ledger_bytes(raw)[1:]
        assert mod.read_records(root)[1] == 1
        monkeypatch.setenv("TPUSNAPSHOT_LEDGER_ROTATE_BYTES", "2048")
        _write(mod, root, records[4:])
        monkeypatch.delenv("TPUSNAPSHOT_LEDGER_ROTATE_BYTES")
        roots[name] = root
    listing = {
        name: sorted(os.listdir(os.path.join(root, ".telemetry"))) for name, root in roots.items()
    }
    assert listing["port"] == listing["jax"] and len(listing["port"]) > 1
    for name, root in roots.items():
        got, skipped = ledger.read_records(root)
        want, jskipped = jax_ledger.read_records(root)
        assert got == want and skipped == jskipped == 0
        assert [r["step"] for r in got] == list(range(12))


def test_timeline_and_slo_give_equal_output():
    records = _records()
    got, want = timeline.analyze_ledger(records), jax_timeline.analyze_ledger(records)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(want, sort_keys=True, default=str)
    assert timeline.render_ledger(records) == jax_timeline.render_ledger(records)
    result, jresult = slo.evaluate(records=records), jax_slo.evaluate(records=records)
    assert slo.render(result) == jax_slo.render(jresult)
    assert [f.as_dict() for f in result["findings"]] == [f.as_dict() for f in jresult["findings"]]
    assert result["healthy"] == jresult["healthy"]


def test_timeline_and_slo_clis_on_a_ledger_file(tmp_path, capsys):
    root = str(tmp_path)
    _write(jax_ledger, root, _records())
    for argv in ([root], [root, "--json"]):
        rc = timeline.main(argv)
        out = capsys.readouterr().out
        jrc = jax_timeline.main(argv)
        jout = capsys.readouterr().out
        assert rc == jrc and out == jout
        rc = slo.main(argv)
        out = capsys.readouterr().out
        jrc = jax_slo.main(argv)
        jout = capsys.readouterr().out
        assert rc == jrc and out == jout
    assert timeline.main([str(tmp_path / "none")]) == jax_timeline.main([str(tmp_path / "none")]) == 2
    # The live rules read sampler statusfiles (the port's sampler writes
    # one here): both packages' CLIs give the same exit code and output.
    from torchsnapshot_tpu_torch.telemetry import sampler

    samples = str(tmp_path / "samples")
    for _ in range(2):
        sampler.RuntimeSampler(rank=0, statusfile_dir=samples).sample_once()
    for argv in ([root, "--samples-dir", samples], [root, "--samples-dir", samples, "--json"]):
        rc = slo.main(argv)
        out = capsys.readouterr().out
        jrc = jax_slo.main(argv)
        jout = capsys.readouterr().out
        assert rc == jrc and out == jout


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_inspect_timeline_on_a_manager_root(tmp_path, capsys, writer):
    base = str(tmp_path / "run")
    rng = np.random.default_rng(6)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    for step in range(3):
        if writer == "port":
            CheckpointManager(base).save(step, {"m": StateDict(w=torch.from_numpy(w + step))})
        else:
            jsnap.CheckpointManager(base).save(step, {"m": jsnap.StateDict(w=jnp.asarray(w + step))})
    records, _ = ledger.read_records(base)
    assert [r["step"] for r in records] == [0, 1, 2]
    assert records == jax_ledger.read_records(base)[0]
    rc = port_inspect([base, "--timeline"])
    out = capsys.readouterr().out
    jrc = jax_inspect([base, "--timeline"])
    jout = capsys.readouterr().out
    assert rc == jrc == 0 and out == jout
    # One row a save, under the header.
    assert sum(1 for ln in out.splitlines() if ln.strip().startswith("step")) >= 1
