"""The port's doctor against the JAX package's: on a real take's report
and on report fixtures made from a seed (every host-side rule tripped by
some of them), both give the same findings (rule, severity, title,
evidence, remediation), the same rendering, and the same CLI exit codes,
and ``inspect --doctor`` agrees on a snapshot the port took."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu.inspect import main as jax_inspect
from torchsnapshot_tpu.telemetry import doctor as jax_doctor
from torchsnapshot_tpu.telemetry import report as jax_flight
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch.inspect import main as port_inspect
from torchsnapshot_tpu_torch.telemetry import doctor

# Rules a report without hot-tier, read-plane or wire blocks can trip.
HOST_RULES = {
    "consume-dominated-restore",
    "read-dominated-restore",
    "stage-dominated-take",
    "budget-stall-dominated",
    "retry-storm",
    "straggler-rank",
    "imbalanced-stripe",
    "checkpoint-overhead-above-budget",
    "missing-rank-summary",
    "dedup-ineffective",
    "host-memory-overcommit",
    "staging-pool-thrash",
}


def _summary(rng, rank, kind):
    wall = float(rng.choice([0.5, 3.0, 20.0, 90.0]))
    phases = {"capture_s": float(rng.uniform(0, 2))}
    if kind == "restore":
        phases.update(read_s=float(rng.choice([0.1, 5.0, 40.0])),
                      consume_s=float(rng.choice([0.1, 5.0, 40.0])),
                      assemble_s=float(rng.uniform(0, 1)))
    else:
        phases.update(write_s=float(rng.uniform(0, wall)), commit_s=0.1)
    nbytes = int(rng.choice([1 << 20, 1 << 30, 8 << 30]))
    stage_s, write_s = float(rng.choice([0.5, 30.0])), float(rng.choice([0.5, 30.0]))
    retries = int(rng.choice([0, 3, 25]))
    cap = 1 << 30
    hwm = int(rng.choice([cap // 4, cap * 3]))
    summary = {
        "rank": rank,
        "wall_s": wall,
        "phases": phases,
        "bytes": nbytes,
        "throughput_mbps": nbytes / (1 << 20) / wall,
        "budget": {"high_water_bytes": nbytes // 2,
                   "stall_s": float(rng.choice([0.0, wall * 0.6]))},
        "scheduler_ops": {
            "stage": {"count": 10, "seconds": stage_s, "bytes": nbytes},
            "write": {"count": 10, "seconds": write_s, "bytes": nbytes},
        },
        "storage_ops": {"fs/write": {"count": 11, "seconds": write_s, "bytes": nbytes}},
        "retries": {"total": retries, "backoff_s": retries * 0.1,
                    "by_op": {"write": retries} if retries else {}},
        "faults": {},
        "memory": {
            "format_version": 1,
            "budget_bytes": int(rng.choice([2 * cap, 64 * cap])),
            "budget_source": "host",
            "high_water_bytes": hwm,
            "domains": {
                "staging_pool": {
                    "cap_bytes": cap, "high_water_bytes": hwm, "end_used_bytes": 0,
                    "pinned_bytes": 0, "residual_bytes": 0,
                    "counters": {"hits": int(rng.choice([0, 500])),
                                 "misses": int(rng.choice([5, 800])),
                                 "waits": int(rng.choice([0, 300]))},
                },
            },
        },
        "churn": {
            "chunk_hits": int(rng.choice([0, 40])), "chunk_misses": 8,
            "chunk_hit_bytes": int(rng.choice([1 << 20, 4 << 20])),
            "leaf_clean_bytes": 1 << 20, "chunk_logical_bytes": 64 << 20,
        },
    }
    if rng.random() < 0.5:
        train = float(rng.uniform(10, 100))
        ckpt = float(rng.choice([0.1, 30.0]))
        summary["goodput"] = {
            "train_s": train, "checkpoint_s": ckpt, "steps": 10,
            "by_mode": {"sync_take": ckpt},
            "checkpoint_overhead_pct": 100 * ckpt / (train + ckpt),
            "goodput_fraction": train / (train + ckpt),
        }
    return summary


def _fixtures(n=240, seed=13):
    rng = np.random.default_rng(seed)
    reports = []
    for _ in range(n):
        kind = str(rng.choice(["take", "async_take", "restore"]))
        world = int(rng.choice([1, 2, 4]))
        ranks = [_summary(rng, r, kind) for r in range(world)]
        if world > 1 and rng.random() < 0.2:
            ranks[-1] = None
        # The JAX package's report builder adds the totals.
        reports.append(jax_flight.build_report(
            kind, "/ckpt/step-1", None if kind == "restore" else "t", world, ranks
        ))
    return reports


def _as_dicts(findings):
    return [f.as_dict() for f in findings]


def test_fixture_findings_are_identical_and_cover_every_host_rule(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_DEDUP_MIN_BYTES", "1024")
    fired = set()
    for report in _fixtures():
        got = doctor.diagnose_report(json.loads(json.dumps(report)))
        want = jax_doctor.diagnose_report(json.loads(json.dumps(report)))
        assert _as_dicts(got) == _as_dicts(want)
        assert doctor.render_findings(got) == jax_doctor.render_findings(want)
        fired |= {f.rule for f in got}
    assert HOST_RULES <= fired, sorted(HOST_RULES - fired)
    assert [r.__name__ for r in doctor.RULES] == [r.__name__ for r in jax_doctor.RULES]


def test_multi_report_diagnosis_is_identical(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_DEDUP_MIN_BYTES", "1024")
    reports = _fixtures(n=30, seed=4)
    for i in range(0, 30, 3):
        batch = reports[i:i + 3]
        assert _as_dicts(doctor.diagnose(batch)) == _as_dicts(jax_doctor.diagnose(batch))


def test_cli_exit_codes_match(tmp_path, capsys):
    reports = _fixtures(n=12, seed=21)
    for i, report in enumerate(reports):
        path = str(tmp_path / f"r{i}.json")
        with open(path, "w") as f:
            json.dump(report, f)
        for argv in ([path], [path, "--json"]):
            rc = doctor.main(argv)
            out = capsys.readouterr().out
            jrc = jax_doctor.main(argv)
            jout = capsys.readouterr().out
            assert rc == jrc and rc in (0, 1)
            if "--json" in argv:
                assert json.loads(out) == json.loads(jout)
    missing = str(tmp_path / "none.json")
    assert doctor.main([missing]) == jax_doctor.main([missing]) == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_inspect_doctor_on_real_snapshots(tmp_path, capsys, writer):
    rng = np.random.default_rng(8)
    arrays = {"w": rng.standard_normal((32, 32)).astype(np.float32)}
    path = str(tmp_path / "snap")
    if writer == "port":
        state = {"m": StateDict({k: torch.from_numpy(v) for k, v in arrays.items()})}
        Snapshot.take(path, state)
        Snapshot(path).restore(state)
    else:
        state = {"m": jsnap.StateDict({k: jnp.asarray(v) for k, v in arrays.items()})}
        jsnap.Snapshot.take(path, state)
        jsnap.Snapshot(path).restore(state)
    reports = doctor._collect_snapshot_reports(path)
    assert [r["kind"] for r in reports] == [
        r["kind"] for r in jax_doctor._collect_snapshot_reports(path)
    ] == ["take", "restore"]
    assert _as_dicts(doctor.diagnose(reports)) == _as_dicts(jax_doctor.diagnose(reports))
    rc = port_inspect([path, "--doctor"])
    out = capsys.readouterr().out
    jrc = jax_inspect([path, "--doctor"])
    jout = capsys.readouterr().out
    assert rc == jrc and rc in (0, 1) and out == jout
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert port_inspect([empty, "--doctor"]) == jax_inspect([empty, "--doctor"]) == 2
