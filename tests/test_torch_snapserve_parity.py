"""The read plane across the two packages: both speak one wire format, so
a port client reads through a JAX server (or fleet) and a JAX client
through a port server (or fleet), bit-exactly; each package's ``plan``
RPC answers the other's client with its own local cut; and a restore cut
by chunk pushdown gives the same bytes as an uncut one in both packages,
fetching only the chunks a box overlaps.

Every server here is in process (a thread) except one port server
subprocess with a bounded start-up wait; every RPC is bounded by
``TPUSNAPSHOT_SNAPSERVE_TIMEOUT_S``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jsnap
from torchsnapshot_tpu import snapserve as jsnapserve
from torchsnapshot_tpu.snapserve import fleet as jfleet
from torchsnapshot_tpu_torch import RemoteSnapshot, Snapshot, StateDict, snapserve, telemetry
from torchsnapshot_tpu_torch.snapserve import fleet as pfleet
from torchsnapshot_tpu_torch.snapserve import pushdown

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    monkeypatch.setenv("TPUSNAPSHOT_SNAPSERVE_DOWN_COOLDOWN_S", "0.2")
    monkeypatch.setenv("TPUSNAPSHOT_SNAPSERVE_TIMEOUT_S", "30")
    yield
    for mod, fl in ((snapserve, pfleet), (jsnapserve, jfleet)):
        for name in fl.local_member_names():
            fl.unregister_local_member(name)
        mod.kill_local_servers()
    # The wire tap is process-wide: a later test's live rules must not read
    # this one's RPCs.
    from torchsnapshot_tpu import wiretap as jwiretap
    from torchsnapshot_tpu_torch import wiretap

    wiretap.reset()
    jwiretap.reset()


def _arrays(seed=11, n_params=4, n=4096):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.standard_normal(n).astype(np.float32) for i in range(n_params)}


def _take(taker, path, arrays, **kwargs):
    if taker == "port":
        Snapshot.take(path, {"m": StateDict(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})}, **kwargs)
    else:
        jsnap.Snapshot.take(path, {"m": jsnap.StateDict(**{k: v.copy() for k, v in arrays.items()})}, **kwargs)


def _restore(client, url, arrays):
    """Restore through ``url`` with ``client``'s package; the leaves as numpy."""
    if client == "port":
        target = {"m": StateDict(**{k: torch.zeros(v.shape) for k, v in arrays.items()})}
        RemoteSnapshot(url).restore(target)
        return {k: target["m"][k].numpy() for k in arrays}
    target = {"m": jsnap.StateDict(**{k: np.zeros_like(v) for k, v in arrays.items()})}
    jsnapserve.RemoteSnapshot(url).restore(target)
    return {k: np.asarray(target["m"][k]) for k in arrays}


def _client_stats(client):
    return (snapserve if client == "port" else jsnapserve).stats_snapshot()


def _assert_bit_exact(got, arrays):
    for k, v in arrays.items():
        assert got[k].tobytes() == v.tobytes(), k


# ------------------------------------------------- one server, both ways


@pytest.mark.parametrize("taker", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_client_reads_through_the_other_packages_server(tmp_path, taker, client):
    """A port client through a JAX server and a JAX client through a port
    server, of a snapshot either package took: bit-exact, every object
    served remotely (no direct fallback), and the server's backend read
    each payload byte once."""
    server_mod = jsnapserve if client == "port" else snapserve
    arrays = _arrays()
    path = str(tmp_path / "snap")
    _take(taker, path, arrays)
    service = server_mod.ReadService()
    server = server_mod.start_local_server(service=service)
    try:
        before = _client_stats(client)
        got = _restore(client, f"snapserve://{server.addr}/{path}", arrays)
        after = _client_stats(client)
        stats = service.stats()
    finally:
        server.stop()
    _assert_bit_exact(got, arrays)
    assert after["fallback_objects"] == before["fallback_objects"]
    assert after["remote_objects"] > before["remote_objects"]
    payload = sum(v.nbytes for v in arrays.values())
    assert payload <= stats["backend_read_bytes"] < 2 * payload + (1 << 20)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_client_reads_through_the_other_packages_fleet(tmp_path, monkeypatch, client):
    """A chunk-stored snapshot through the other package's 3-member fleet:
    bit-exact, routed over more than one member, no direct fallback."""
    fleet_mod = jfleet if client == "port" else pfleet
    arrays = _arrays(seed=12, n=16384)
    path = str(tmp_path / "step-1")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    _take("port", path, arrays, chunks=True)
    lf = fleet_mod.start_local_fleet(n=3)
    try:
        before = _client_stats(client)
        got = _restore(client, f"snapserve://{lf.addr_spec}/{path}", arrays)
        after = _client_stats(client)
    finally:
        lf.stop()
    _assert_bit_exact(got, arrays)
    assert after["fallback_objects"] == before["fallback_objects"]
    served = {a for a, e in after["servers"].items() if e["objects"] > before["servers"].get(a, {}).get("objects", 0)}
    assert len(served) > 1, after["servers"]


def test_jax_client_through_port_server_subprocess(tmp_path):
    """``python -m torchsnapshot_tpu_torch.snapserve.server`` for real,
    fronting an fs snapshot the JAX package took, read by a JAX client."""
    arrays = _arrays(seed=13, n_params=2)
    path = str(tmp_path / "snap")
    _take("jax", path, arrays)
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchsnapshot_tpu_torch.snapserve.server",
         "--addr", "127.0.0.1:0", "--port-file", str(port_file)],
        env={**os.environ, "PYTHONPATH": _REPO_ROOT},
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 90
        while not (port_file.exists() and port_file.read_text().strip()):
            assert proc.poll() is None, "server process died during startup"
            assert time.monotonic() < deadline, "server never bound"
            time.sleep(0.1)
        addr = port_file.read_text().strip()
        got = _restore("jax", f"snapserve://{addr}/{path}", arrays)
        stats = snapserve.fetch_server_stats(addr)
        jstats = jsnapserve.fetch_server_stats(addr)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    _assert_bit_exact(got, arrays)
    assert stats["manifest_loads"] == 1 and stats["requests"] >= 1
    # Both packages' stats RPC reads the same counters.
    assert jstats["requests"] == stats["requests"]
    assert jstats["backend_read_bytes"] == stats["backend_read_bytes"]


@pytest.mark.parametrize("client", ["port", "jax"])
def test_plan_rpc_of_the_other_package_equals_the_local_cut(client):
    doc = {
        "shape": [64, 64],
        "itemsize": 4,
        "record_sizes": [4096] * 4,
        "boxes": [[[0, 16], [0, 64]], [[48, 64], [0, 64]]],
    }
    server_mod, client_mod = (jsnapserve, snapserve) if client == "port" else (snapserve, jsnapserve)
    server = server_mod.start_local_server()
    try:
        remote = client_mod.plan_remote(server.addr, doc)
    finally:
        server.stop()
    from torchsnapshot_tpu.snapserve import pushdown as jpushdown

    assert remote == pushdown.plan_from_doc(doc) == jpushdown.plan_from_doc(doc)
    assert remote["indices"] == [0, 3]


# ------------------------------------------------------------ chunk pushdown


def test_pushdown_cut_restores_the_same_bytes_in_the_port(tmp_path, monkeypatch):
    """A 1 MiB array in 16 content chunks, taken by the JAX package,
    restored as row halves by a spawned gloo world of 2 through one port
    server, with pushdown and without: the same bytes; with pushdown each
    rank fetches half the chunks, without it all of them."""
    from tests import torch_rank_workers as workers
    from torchsnapshot_tpu_torch.utils.test_utils import run_multiprocess

    arr = np.random.default_rng(14).standard_normal((512, 512)).astype(np.float32)
    path = str(tmp_path / "step-1")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", str(64 << 10))
    jsnap.Snapshot.take(path, {"m": jsnap.StateDict(w=arr)}, chunks=True, replicated=["**"])
    server = snapserve.start_local_server()
    out = tmp_path / "ranks"
    out.mkdir()
    try:
        run_multiprocess(
            workers.restore_rows_through_snapserve, 2,
            (f"snapserve://{server.addr}/{path}", arr, str(out), (True, False)), timeout_s=120,
        )
    finally:
        server.stop()
    fetched = {}
    for cut, suffix in ((True, ""), (False, ".uncut")):
        recs = [json.loads((out / f"rank{r}{suffix}.json").read_text()) for r in range(2)]
        assert all(r["fallback_objects"] == 0 for r in recs), recs
        fetched[cut] = [r["chunk_bytes"] for r in recs]
    assert fetched[True] == [arr.nbytes // 2] * 2
    assert fetched[False] == [arr.nbytes] * 2


def test_pushdown_toggle_restores_the_same_bytes_in_jax(tmp_path, monkeypatch):
    """The JAX package restores the same port-taken chunk-stored array as
    row blocks of an 8-device CPU mesh through a port server, with
    pushdown on and off: the same bytes, all served remotely. (One JAX
    process holds every block, so its cut keeps every chunk; the cut
    itself is held to the port's below.)"""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    arr = np.random.default_rng(15).standard_normal((512, 512)).astype(np.float32)
    path = str(tmp_path / "step-1")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", str(64 << 10))
    Snapshot.take(path, {"m": StateDict(w=torch.from_numpy(arr.copy()))}, chunks=True)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("x",))
    server = snapserve.start_local_server()
    got = {}
    try:
        for cut in (True, False):
            if not cut:
                monkeypatch.setenv("TPUSNAPSHOT_CHUNK_PUSHDOWN", "0")
            before = jsnapserve.stats_snapshot()
            t = {"m": jsnap.StateDict(w=jax.device_put(np.zeros_like(arr), NamedSharding(mesh, P("x"))))}
            jsnapserve.RemoteSnapshot(path, addr=server.addr).restore(t)
            after = jsnapserve.stats_snapshot()
            assert after["fallback_objects"] == before["fallback_objects"]
            got[cut] = np.asarray(t["m"]["w"]).tobytes()
    finally:
        server.stop()
    assert got[True] == got[False] == arr.tobytes()


@pytest.mark.parametrize("rows", [(0, 16), (16, 32), (10, 40), (0, 64)])
def test_pushdown_cut_matches_jax(tmp_path, monkeypatch, rows):
    """On the records of a real chunk take, the port's cut for a row box
    selects the records the JAX package's ``select_records`` does, and
    both packages' chunk read states then read the same chunk objects at
    the same offsets of the object."""
    from torchsnapshot_tpu import io_preparer as jio_preparer
    from torchsnapshot_tpu.snapserve import pushdown as jpushdown
    from torchsnapshot_tpu_torch import io_preparer

    arr = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")
    snap = Snapshot.take(str(tmp_path / "step-1"), {"m": StateDict(w=torch.from_numpy(arr))}, chunks=True)
    records = snap.get_manifest()["0/m/w"].chunks
    box = (slice(*rows), slice(0, 64))
    cut = io_preparer._pushdown_cut(records, [64, 64], box, 4)
    sel = jpushdown.select_records(
        [int(r["n"]) for r in records],
        jpushdown.needed_intervals((64, 64), [[rows, (0, 64)]], 4),
    )
    want = sel.indices if len(sel.indices) < len(records) else None
    assert cut == want
    port_state = io_preparer._ContentChunksReadState(arr.nbytes, inner=None, dtype_name="float32")
    port_reqs = port_state.build_reads(records, None, cut)
    jax_state = jio_preparer._ContentChunksReadState(
        inner=None, records=records, dtype_name="float32", store_base=None, selected=cut
    )
    jax_reqs = jax_state.build_reads()
    assert [r.path for r in port_reqs] == [r.path for r in jax_reqs]
    assert [r.buffer_consumer._start for r in port_reqs] == [
        r.buffer_consumer._offset for r in jax_reqs
    ]


def test_pushdown_counts_skipped_bytes_in_the_port(tmp_path, monkeypatch):
    """The port's cut counts the bytes it skipped, as the JAX package's
    does: a restore of one row block of a chunk-stored array through the
    plan-level entry (a DTensor box of a world of 1 is the whole array,
    so the box is planned directly)."""
    from torchsnapshot_tpu_torch import io_preparer
    from torchsnapshot_tpu_torch.telemetry import metrics as pmetrics

    arr = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    path = str(tmp_path / "step-1")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TPUSNAPSHOT_CHUNK_MIN_BYTES", "0")
    snap = Snapshot.take(path, {"m": StateDict(w=torch.from_numpy(arr))}, chunks=True)
    entry = snap.get_manifest()["0/m/w"]
    records = entry.chunks
    assert len(records) == 4
    counter = telemetry.counter(pmetrics.CHUNK_PUSHDOWN_SKIPPED_BYTES)
    before = counter.value
    rows = (slice(16, 32), slice(0, 64))
    assert io_preparer._pushdown_cut(records, [64, 64], rows, 4) == [1]
    assert counter.value - before == 3 * 4096
    # A box covering the whole object is never cut, and nothing counts.
    assert io_preparer._pushdown_cut(records, [64, 64], (slice(0, 64), slice(0, 64)), 4) is None
    assert counter.value - before == 3 * 4096


# ------------------------------------------------ pinned fault, both packages


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fault11_pooled_connections_outlive_a_restore_until_gc(tmp_path, pkg):
    """ROADMAP Queue 3, fault 11 (open, both packages): a restore's
    pooled connections belong to the event loop its reads ran on, which
    has closed when the plugin is closed, so ``close()``'s
    ``transport.abort()`` fails and the sockets stay open until garbage
    collection; a server's graceful stop then waits on them. Pinned as it
    is in both packages."""
    import gc

    arrays = _arrays(seed=16, n_params=2, n=1024)
    path = str(tmp_path / "snap")
    _take(pkg, path, arrays)
    server = snapserve.start_local_server()

    def open_conns():
        with server._lock:
            return sum(1 for w in server._conn_writers if not w.is_closing())

    gc.disable()
    try:
        got = _restore(pkg, f"snapserve://{server.addr}/{path}", arrays)
        deadline = time.monotonic() + 10
        while open_conns() == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        left = open_conns()
        gc.collect()
        deadline = time.monotonic() + 10
        while open_conns() and time.monotonic() < deadline:
            time.sleep(0.05)
        after_gc = open_conns()
    finally:
        gc.enable()
        server.stop()
    _assert_bit_exact(got, arrays)
    assert left > 0
    assert after_gc == 0
