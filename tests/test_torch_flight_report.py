"""Flight reports of the port against the JAX package's: a take and a
restore of the same state on fs write the same telemetry objects, whose
reports have the same recursive key set and the same byte and request
counts; each package renders and inspects the other's reports; an async
take's drain spans carry the take's trace id; a world-2 take's rank
reports sum to the payload bytes its manifest names, on both commit
routes."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import tracing as jax_tracing
from torchsnapshot_tpu.inspect import main as jax_inspect
from torchsnapshot_tpu.telemetry import goodput as jax_goodput
from torchsnapshot_tpu.telemetry import report as jax_flight
from torchsnapshot_tpu import wiretap as jax_wiretap
from torchsnapshot_tpu.hottier import tier as jax_ht_tier
from torchsnapshot_tpu.telemetry import memwatch as jax_memwatch
from torchsnapshot_tpu_torch import Snapshot, StateDict, tracing, wiretap
from torchsnapshot_tpu_torch.hottier import tier as ht_tier
from torchsnapshot_tpu_torch.telemetry import memwatch
from torchsnapshot_tpu_torch.inspect import main as port_inspect
from torchsnapshot_tpu_torch.telemetry import goodput
from torchsnapshot_tpu_torch.telemetry import report as flight
from torchsnapshot_tpu_torch.utils.test_utils import run_thread_ranks

# The hot tier's and the wiretap's memory domains are registered at
# import in both packages, so both reports list them. The restore
# pipelines differ by design: every port
# placement rides the H2D pipeline (``h2d_overlap``, never ``device_put``
# or ``reassemble``), and a host-target restore of whole objects leases
# no pooled buffer, so the port has no ``staging_pool`` domain on the
# CPU. The consume profile's sub-step names and that domain are set
# aside; every other key must match.
_UNPORTED_DOMAINS = ("staging_pool",)
_PIPELINE_KEYS = ("/consume_profile/substeps", "/consume_profile/h2d_overlap_gbps")


@pytest.fixture(autouse=True)
def _import_time_domains():
    """Both packages' reports list the memory domains that importing the
    hot tier and the wiretap registers. An earlier test in this process
    may have reset one package's memwatch or left hosts in one package's
    tier, so each case starts both packages from an empty tier and those
    domains alone. A read-plane server an earlier test killed may still be
    winding down on its thread (its cache and tenant domains would show up
    in one package's report): every in-process server of both packages is
    stopped, its thread joined, first."""
    from torchsnapshot_tpu.snapserve import server as jax_sv_server
    from torchsnapshot_tpu_torch.snapserve import server as sv_server

    for mod in (sv_server, jax_sv_server):
        with mod._LOCAL_LOCK:
            servers = list(mod._LOCAL_SERVERS)
        for server in servers:
            server.stop()
    for mw, tier, tap in ((memwatch, ht_tier, wiretap), (jax_memwatch, jax_ht_tier, jax_wiretap)):
        tier.reset_hot_tier()
        mw.reset()
        mw.register_provider("hottier.host", tier._mem_hosts_provider)
        mw.register_provider("hottier.shadow", tier._mem_shadow_provider, external=True)
        tap.reset()  # registers wiretap.ring again
    yield


@pytest.fixture(autouse=True)
def _fresh_goodput():
    """Goodput is per process and a report carries what it has summed:
    each case starts both packages' accumulators from nothing, whatever
    ran before it in this process."""
    goodput.reset()
    jax_goodput.reset()
    yield
    goodput.reset()
    jax_goodput.reset()


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 48)).astype(np.float32),
        "b": rng.standard_normal(48).astype(np.float32),
        "e": rng.integers(0, 1 << 30, (16, 8)).astype(np.int32),
    }


def _state(kind, seed=0):
    if kind == "port":
        return {"m": StateDict({k: torch.from_numpy(v.copy()) for k, v in _arrays(seed).items()})}
    return {"m": jsnap.StateDict({k: jnp.asarray(v) for k, v in _arrays(seed).items()})}


def _keys(doc, prefix=""):
    out = set()
    if isinstance(doc, dict):
        for k, v in doc.items():
            if prefix.endswith("/memory/domains") and k.startswith(_UNPORTED_DOMAINS):
                continue
            key = f"{prefix}/{k}"
            if key.endswith(_PIPELINE_KEYS):
                continue
            out.add(key)
            out |= _keys(v, key)
    elif isinstance(doc, list):
        for v in doc:
            out |= _keys(v, prefix + "[]")
    return out


def _counts(report):
    """The exact, timing-free numbers of a report's rank summaries."""
    out = []
    for r in report["ranks"]:
        out.append({
            "bytes": r["bytes"],
            "scheduler_ops": {k: (v["count"], v["bytes"]) for k, v in r["scheduler_ops"].items()},
            "storage_ops": {k: (v["count"], v["bytes"]) for k, v in r["storage_ops"].items()},
            "faults": r["faults"],
            "retries": r["retries"]["total"],
        })
    return out


def _files(root):
    found = set()
    for d, _, files in os.walk(root):
        for f in files:
            found.add(os.path.relpath(os.path.join(d, f), root))
    return found


def _run(kind, root):
    (goodput if kind == "port" else jax_goodput).reset()
    pkg = Snapshot if kind == "port" else jsnap.Snapshot
    path = os.path.join(root, "snap")
    snap = pkg.take(path, _state(kind))
    snap.restore(_state(kind, seed=1))
    pending = pkg.async_take(os.path.join(root, "async"), _state(kind))
    pending.wait()
    return path


def test_take_and_restore_write_the_same_telemetry_as_jax(tmp_path):
    port_path = _run("port", str(tmp_path / "port"))
    jax_path = _run("jax", str(tmp_path / "jax"))
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    assert {".report.json", ".report.restore.json", ".telemetry/ledger.jsonl"} <= _files(port_path)
    for fname in (".report.json", ".report.restore.json"):
        with open(os.path.join(port_path, fname)) as f:
            port = json.load(f)
        with open(os.path.join(jax_path, fname)) as f:
            jax = json.load(f)
        assert _keys(port) == _keys(jax), (
            fname, sorted(_keys(port) ^ _keys(jax))
        )
        assert _counts(port) == _counts(jax), fname
        assert (port["kind"], port["world_size"]) == (jax["kind"], jax["world_size"])
    for name in ("snap", "async"):
        for kind in ("port", "jax"):
            with open(os.path.join(str(tmp_path / kind), name, ".report.json")) as f:
                report = json.load(f)
            assert report["kind"] == ("take" if name == "snap" else "async_take")
            assert report["totals"]["bytes"] == sum(v.nbytes for v in _arrays().values())


def test_reports_render_and_inspect_both_ways(tmp_path, capsys):
    for kind in ("port", "jax"):
        path = _run(kind, str(tmp_path / kind))
        with open(os.path.join(path, ".report.json")) as f:
            report = json.load(f)
        assert flight.render_report(report) == jax_flight.render_report(report)
        assert port_inspect([path, "--report"]) == 0
        out = capsys.readouterr().out
        assert jax_inspect([path, "--report"]) == 0
        jout = capsys.readouterr().out
        # Two reports (take, restore) rendered in the same layout.
        assert [ln.split()[0] for ln in out.splitlines() if ln.strip()] == [
            ln.split()[0] for ln in jout.splitlines() if ln.strip()
        ]
    assert port_inspect([str(tmp_path / "nothing"), "--report"]) == 1


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_async_drain_spans_carry_the_take_trace_id(tmp_path, kind):
    tr = tracing if kind == "port" else jax_tracing
    pkg = Snapshot if kind == "port" else jsnap.Snapshot
    trace = str(tmp_path / "trace.json")
    tr.enable(trace)
    try:
        pending = pkg.async_take(str(tmp_path / "snap"), _state(kind))
        pending.wait()
    finally:
        tr.flush()
        tr.disable()
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "b"]
    writes = [e for e in events if e["name"] == "write"]
    assert len(writes) == len(_arrays())
    ids = {e["args"].get("trace") for e in events}
    assert len(ids) == 1 and None not in ids
    assert {e["name"] for e in events} >= {"stage", "write"}


@pytest.mark.parametrize("route", ["coordinator", "storage"])
def test_world2_rank_reports_sum_to_the_manifest(tmp_path, monkeypatch, route):
    if route == "storage":
        monkeypatch.setenv("TPUSNAPSHOT_COMMIT_VIA_STORAGE_BYTES", "1")
    path = str(tmp_path / "snap")
    rng = np.random.default_rng(3)
    per_rank = [rng.standard_normal(100 + 37 * r).astype(np.float32) for r in range(2)]
    shared = rng.standard_normal(64).astype(np.float32)

    def take(coord, rank):
        state = {"m": StateDict(own=torch.from_numpy(per_rank[rank]), shared=torch.from_numpy(shared))}
        Snapshot.take(path, state, coord=coord, replicated=["m/shared"])

    run_thread_ranks(2, take)
    with open(os.path.join(path, ".report.json")) as f:
        report = json.load(f)
    assert report["world_size"] == 2 and [r["rank"] for r in report["ranks"]] == [0, 1]
    payload = sum(
        os.path.getsize(os.path.join(path, p)) for p in _files(path) if not p.startswith(".")
    )
    assert sum(r["bytes"] for r in report["ranks"]) == report["totals"]["bytes"] == payload
    assert payload == sum(a.nbytes for a in per_rank) + shared.nbytes
    # Rank 0 merged the rank summaries and removed them.
    assert not any(p.startswith(".report/") for p in _files(path))
    # The JAX package reads the port's world-2 report.
    assert jax_inspect([path, "--report"]) == 0
