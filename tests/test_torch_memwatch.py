"""The port's memwatch against the JAX package's: the same register,
charge, window, forecast and leak sequence gives equal snapshots, window
blocks and findings; a ``mem_pressure`` schedule of either package trips
the doctor's ``host-memory-overcommit`` rule on a real restore's report;
and the host figures fall back the same way without ``psutil``."""

import json
import sys

import numpy as np
import pytest
import torch

from torchsnapshot_tpu.telemetry import doctor as jax_doctor
from torchsnapshot_tpu.telemetry import memwatch as jax_memwatch
from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch import faultline as fl
from torchsnapshot_tpu_torch.telemetry import doctor, memwatch

# Figures of this process at the moment of reading: they differ between
# two calls of the same sequence.
_LIVE = ("rss_bytes", "headroom_bytes")


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_HOST_MEM_BUDGET", str(1 << 40))
    memwatch.reset()
    jax_memwatch.reset()
    yield
    memwatch.reset()
    jax_memwatch.reset()


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in _LIVE}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _sequence(mod, seed=9):
    rng = np.random.default_rng(seed)
    pool = mod.register("staging_pool", cap_bytes=64 << 20, watch_residual="pinned")
    write = mod.register("scheduler.write", cap_bytes=32 << 20, transient=True, watch_residual="used")
    dev = mod.register("scheduler.read.device", cap_bytes=1 << 30, transient=True, external=True)
    token = mod.window_begin()
    blocks = []
    for i in range(20):
        used = int(rng.integers(0, 48 << 20))
        pool.set_used(used, pinned_bytes=used // 2)
        write.charge(int(rng.integers(0, 1 << 20)))
        dev.set_used(int(rng.integers(0, 1 << 30)), pinned_bytes=0)
        pool.counter("hits" if i % 3 else "misses")
        if i == 10:
            inner = mod.window_begin()
        if i == 15:
            blocks.append(mod.window_collect(inner))
    mod.forecast(1 << 20, kind="take")
    blocks.append(mod.window_collect(token))
    snap = mod.snapshot()
    for d in (pool, write, dev):
        d.close()
    return blocks, snap


def test_same_sequence_gives_equal_blocks_and_snapshots():
    port_blocks, port_snap = _sequence(memwatch)
    jax_blocks, jax_snap = _sequence(jax_memwatch)
    assert _strip(port_blocks) == _strip(jax_blocks)
    assert _strip(port_snap) == _strip(jax_snap)
    assert port_blocks[-1]["domains"]["staging_pool"]["counters"] == {"hits": 13, "misses": 7}
    assert memwatch.reconcile(port_blocks[-1]) == jax_memwatch.reconcile(jax_blocks[-1]) == []


def test_forecast_of_an_overcommit_is_the_same(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_HOST_MEM_BUDGET", str(1 << 20))
    got = [_strip(memwatch.forecast(n, kind="restore")) for n in (0, 1 << 30)]
    want = [_strip(jax_memwatch.forecast(n, kind="restore")) for n in (0, 1 << 30)]
    assert got == want and got[1] is not None


def _ledger_records(grow):
    records = []
    for i in range(8):
        residual = (i * (64 << 20)) if grow else (1 << 20)
        records.append({
            "kind": "take", "step": i,
            "memory": {"domains": {"staging_pool": {"residual_bytes": residual}}},
        })
    return records


@pytest.mark.parametrize("grow", [True, False])
def test_leak_findings_are_the_same(grow):
    records = json.loads(json.dumps(_ledger_records(grow)))
    got = [f.as_dict() for f in memwatch.leak_findings(records)]
    want = [f.as_dict() for f in jax_memwatch.leak_findings(records)]
    assert got == want
    assert bool(got) == grow


def test_mem_pressure_on_a_restore_trips_the_doctor(tmp_path, monkeypatch):
    """A ``mem_pressure("staging_pool", …)`` schedule during a restore
    that leases pooled buffers: the restore report's memory block shows
    the pool over its shrunk cap, and both packages' doctors name
    ``host-memory-overcommit``."""
    from torchsnapshot_tpu_torch import io_preparer, staging_pool

    # Chunks split along dim 1 are no runs of the target: each is read
    # in sub-reads assembled in pooled buffers, on the CPU too.
    monkeypatch.setattr(io_preparer, "MAX_CHUNK_SIZE_BYTES", 256 << 10)
    monkeypatch.setenv("TPUSNAPSHOT_PARALLEL_READ_THRESHOLD", str(64 << 10))
    staging_pool.reset_staging_pool()
    path = str(tmp_path / "snap")
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((256, 1024)).astype(np.float32))
    Snapshot.take(path, {"m": StateDict(w=w)})
    target = StateDict(w=torch.zeros_like(w))
    with fl.inject(fl.FaultSchedule().mem_pressure("staging_pool", 1024, op="read", path="chunked/*")) as ctl:
        Snapshot(path).restore({"m": target})
    assert torch.equal(target["w"], w)
    assert ctl.fault_counts() == {"mem_pressure": 1}
    with open(f"{path}/.report.restore.json") as f:
        report = json.load(f)
    pool = report["ranks"][0]["memory"]["domains"]["staging_pool"]
    assert pool["cap_bytes"] == 1024 and pool["high_water_bytes"] > 1024
    assert report["ranks"][0]["faults"] == {"mem_pressure": 1}
    rules = [f.rule for f in doctor.diagnose_report(report)]
    assert "host-memory-overcommit" in rules
    assert rules == [f.rule for f in jax_doctor.diagnose_report(report)]
    staging_pool.reset_staging_pool()


def test_host_figures_without_psutil_fall_back_as_in_jax(monkeypatch):
    monkeypatch.delenv("TPUSNAPSHOT_HOST_MEM_BUDGET")
    monkeypatch.setitem(sys.modules, "psutil", None)  # import raises
    assert memwatch.process_rss_bytes() is None
    assert jax_memwatch.process_rss_bytes() is None
    budget, source = memwatch.host_budget_bytes()
    assert (budget, source) == jax_memwatch.host_budget_bytes()
    assert source in ("cgroup", "unknown")
