"""The port's metrics registry and exporters against the JAX package's:
the metric name constants, the recording shorthands' deltas, the
Prometheus textfile (byte-equal, and each package parses the other's)
and the JSON-lines export; and the port of the JAX package's chunk-store
telemetry cases (``test_chunkstore.py::TestTelemetry``)."""

import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu.telemetry import export as jax_export
from torchsnapshot_tpu.telemetry import metrics as jax_metrics
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, telemetry
from torchsnapshot_tpu_torch.telemetry import export as port_export
from torchsnapshot_tpu_torch.telemetry import ledger as port_ledger
from torchsnapshot_tpu_torch.telemetry import metrics as port_metrics


def _constants(mod):
    return {
        k: getattr(mod, k)
        for k in dir(mod)
        if k.isupper() and not k.startswith("_") and isinstance(getattr(mod, k), (str, int, float, tuple))
    }


# Metrics of the port with no counterpart in the JAX package: the bytes
# the port's memory:// plugin serves as views of its stored objects.
_PORT_ONLY = {"STORAGE_READ_VIEW_BYTES"}


def test_every_metric_name_constant_is_equal():
    jax_names, port_names = _constants(jax_metrics), _constants(port_metrics)
    assert set(port_names) - set(jax_names) == _PORT_ONLY
    assert {k: v for k, v in port_names.items() if k not in _PORT_ONLY} == jax_names
    assert len(port_names) > 60


def _drive(mod, registry):
    """A fixed sequence of recordings into ``registry``."""
    rng = np.random.default_rng(5)
    for i in range(40):
        registry.counter(mod.STORAGE_RETRIES, op="write").inc()
        registry.counter(mod.FAULTS_INJECTED, kind=("transient", "crash")[i % 2]).inc(2)
        registry.histogram(mod.STORAGE_OP_SECONDS, backend="fs", op="read").observe(
            float(rng.exponential(0.01))
        )
        registry.histogram(mod.STORAGE_OP_BYTES, backend="fs", op="read").observe(
            int(rng.integers(1, 1 << 24))
        )
        registry.gauge(mod.SCHED_BUDGET_HWM, pipeline="write").set_max(float(rng.integers(0, 1000)))
    registry.gauge(mod.RESTORE_POOL_RETAINED).set(123.0)
    registry.counter(mod.CODEC_BYTES, dir="in", codec='z"l\\ib').inc(7)


def test_same_operations_give_equal_snapshots_and_deltas():
    jreg, preg = jax_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()
    jbefore, pbefore = jreg.snapshot(), preg.snapshot()
    _drive(jax_metrics, jreg)
    _drive(port_metrics, preg)
    assert preg.snapshot() == jreg.snapshot()
    assert port_metrics.diff_snapshots(pbefore, preg.snapshot()) == jax_metrics.diff_snapshots(
        jbefore, jreg.snapshot()
    )


def test_recording_shorthands_move_the_process_registry():
    before = telemetry.snapshot()
    telemetry.record_storage_op("fs", "write", 0.5, 1024)
    telemetry.record_scheduler_op("stage", 0.25, 4096)
    telemetry.record_coord_wait("barrier", 0.125)
    delta = port_metrics.diff_snapshots(before, telemetry.snapshot())
    assert port_metrics.sum_samples(delta, port_metrics.STORAGE_OP_BYTES) == 1024
    assert port_metrics.sum_samples(delta, port_metrics.SCHED_OP_BYTES) == 4096
    assert port_metrics.sum_samples(delta, port_metrics.COORD_WAIT_SECONDS) == pytest.approx(0.125)


def test_textfile_is_byte_equal_and_parses_both_ways(tmp_path):
    jreg, preg = jax_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()
    _drive(jax_metrics, jreg)
    _drive(port_metrics, preg)
    jpath, ppath = str(tmp_path / "jax.prom"), str(tmp_path / "port.prom")
    jax_export.write_textfile(jpath, jreg)
    port_export.write_textfile(ppath, preg)
    with open(jpath, "rb") as f:
        jdoc = f.read()
    with open(ppath, "rb") as f:
        pdoc = f.read()
    assert pdoc == jdoc and len(pdoc) > 1000
    assert port_export.parse_textfile(jdoc.decode()) == jax_export.parse_textfile(pdoc.decode())
    assert port_export.parse_textfile(pdoc.decode()) == jax_export.parse_textfile(jdoc.decode())


def test_env_export_after_a_take(tmp_path, monkeypatch):
    """``TPUSNAPSHOT_METRICS_TEXTFILE`` and ``TPUSNAPSHOT_TELEMETRY_JSONL``
    export after a take: the JAX package's parser reads the textfile, and
    the JSON line is the take's rank summary."""
    prom, jsonl = str(tmp_path / "m.prom"), str(tmp_path / "t.jsonl")
    monkeypatch.setenv("TPUSNAPSHOT_METRICS_TEXTFILE", prom)
    monkeypatch.setenv("TPUSNAPSHOT_TELEMETRY_JSONL", jsonl)
    Snapshot.take(str(tmp_path / "s"), {"m": StateDict(w=torch.arange(64.0))})
    # The textfile is one a process (the pid before the extension); the
    # JSON lines append to the one file.
    pid = os.getpid()
    with open(str(tmp_path / f"m.pid{pid}.prom")) as f:
        parsed = jax_export.parse_textfile(f.read())
    assert port_metrics.TAKES_TOTAL in parsed
    lines = [json.loads(x) for x in open(jsonl).read().splitlines()]
    assert lines[-1]["kind"] == "take" and lines[-1]["bytes"] == 256


# ----------------------------------------------- chunk-store telemetry cases


def _state(seed):
    rng = np.random.default_rng(seed)
    return {
        "m": StateDict(
            w=torch.from_numpy(rng.standard_normal(4096).astype(np.float32)),
            b=torch.from_numpy(rng.standard_normal(3000).astype(np.float32)),
        )
    }


@pytest.fixture
def _small_chunks(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")
    monkeypatch.setenv("TPUSNAPSHOT_SWEEP_MIN_AGE_S", "0")
    monkeypatch.setenv("TPUSNAPSHOT_REFS_MIN_AGE_S", "0")


class TestTelemetry:
    def test_ledger_physical_and_codec_ratio(self, tmp_path, _small_chunks):
        d = str(tmp_path)
        state = _state(19)
        mgr = CheckpointManager(d, chunks=True, codec="zlib")
        mgr.save(1, state)
        mgr.save(2, state)
        records, _ = port_ledger.read_records(d)
        takes = [r for r in records if r.get("kind") == "take"]
        assert len(takes) == 2
        churn = takes[1]["churn"]
        assert churn["physical_bytes"] == 0  # an unchanged retake
        assert churn["unchanged_bytes"] > 0
        assert churn["basis"] == "incremental"
        assert churn["efficiency"] == pytest.approx(1.0)
        c0 = takes[0]["churn"]
        assert 0 < c0["codec_ratio"] <= 1.0
        assert 0 < c0["physical_bytes"] <= c0["added_bytes"]

    def test_flight_report_surfaces_encode_op(self, tmp_path, _small_chunks):
        d = str(tmp_path)
        Snapshot.take(f"{d}/step-1", _state(23), chunks=True, codec="zlib")
        report = json.load(open(f"{d}/step-1/.report.json"))
        ops = report["ranks"][0]["scheduler_ops"]
        assert "encode" in ops, sorted(ops)
        assert ops["encode"]["count"] > 0
        assert ops["encode"]["bytes"] > 0

    def test_doctor_dedup_ineffective(self, monkeypatch):
        from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_report

        monkeypatch.setenv("TPUSNAPSHOT_DEDUP_MIN_BYTES", "1024")

        def _report(hit, clean, logical, misses=4):
            return {
                "kind": "take",
                "ranks": [
                    {
                        "rank": 0,
                        "churn": {
                            "chunk_hits": 8,
                            "chunk_misses": misses,
                            "chunk_hit_bytes": hit,
                            "leaf_clean_bytes": clean,
                            "chunk_logical_bytes": logical,
                        },
                    }
                ],
            }

        rules = [f.rule for f in diagnose_report(_report(1 << 20, 1 << 20, 4 << 20))]
        assert "dedup-ineffective" in rules
        rules = [f.rule for f in diagnose_report(_report(2 << 20, 1 << 20, 4 << 20))]
        assert "dedup-ineffective" not in rules
        rules = [f.rule for f in diagnose_report(_report(0, 0, 4 << 20))]
        assert "dedup-ineffective" not in rules

    def test_chunk_metrics_counters(self, tmp_path, _small_chunks):
        d = str(tmp_path)
        state = _state(20)
        before = telemetry.snapshot()
        Snapshot.take(f"{d}/step-1", state, chunks=True)
        Snapshot.take(f"{d}/step-2", state, chunks=True)
        delta = port_metrics.diff_snapshots(before, telemetry.snapshot())
        hits = port_metrics.samples_by_label(delta, port_metrics.CHUNKSTORE_CHUNKS, "result")
        assert hits.get("hit", 0) > 0 and hits.get("miss", 0) > 0
        # The second take of the same state hits every chunk the first
        # wrote.
        assert hits["hit"] == hits["miss"]
        by = port_metrics.samples_by_label(delta, port_metrics.CHUNKSTORE_BYTES, "result")
        assert by["hit"] == (4096 + 3000) * 4
