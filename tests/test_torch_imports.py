"""The PyTorch port and its examples (``examples_torch/``) stand alone:
they never import JAX, optax or the JAX package, and they run where PyYAML, psutil, ml_dtypes, zstandard and the cloud SDKs
(boto3, aiobotocore, google-cloud-storage) are not installed (the machine
with the card has none of them)."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (
    sorted((ROOT / "torchsnapshot_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples_torch").glob("*.py"))
)
FORBIDDEN_ANYWHERE = {"jax", "jaxlib", "optax", "torchsnapshot_tpu"}
FORBIDDEN_AT_MODULE_LEVEL = {
    "yaml", "psutil", "ml_dtypes", "triton", "zstandard", "boto3", "aiobotocore", "google",
}


def _imports(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node, node.module.split(".")[0]


def _module_level(tree):
    """Statements that run at import: the module body, descending into
    if/try/with blocks but not into functions or classes."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_optional_packages(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    anywhere = {name for _, name in _imports(ast.walk(tree))}
    assert not anywhere & FORBIDDEN_ANYWHERE, path
    module_level = {name for _, name in _imports(_module_level(tree))}
    assert not module_level & FORBIDDEN_AT_MODULE_LEVEL, path


def test_port_runs_with_optional_packages_blocked(tmp_path):
    script = textwrap.dedent(
        f"""
        import importlib.abc, sys

        # Namespace packages (google, google.cloud) may be made at start-up
        # by .pth files; only what is imported from here on counts.
        PRESENT = set(sys.modules)

        BLOCKED = {{"yaml", "psutil", "ml_dtypes", "jax", "jaxlib", "optax", "torchsnapshot_tpu",
                   "zstandard", "boto3", "aiobotocore", "google"}}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        from torchsnapshot_tpu_torch import CheckpointManager, RNGState, Snapshot, StateDict
        from torchsnapshot_tpu_torch.models import transformer
        from torchsnapshot_tpu_torch.parallel import collectives, mesh, ring_attention, ulysses
        from torchsnapshot_tpu_torch.utils import test_utils
        from torchsnapshot_tpu_torch import staging_pool
        from torchsnapshot_tpu_torch.telemetry import consume_profile
        from torchsnapshot_tpu_torch import chunkstore, codecs, fingerprint, incremental
        from torchsnapshot_tpu_torch.ops import fingerprint as fingerprint_ops
        from torchsnapshot_tpu_torch import inspect
        from torchsnapshot_tpu_torch.storage_plugins import gcs, s3
        from torchsnapshot_tpu_torch import dryrun, interop
        from torchsnapshot_tpu_torch.interop.reference_writer import convert_back
        from torchsnapshot_tpu_torch.models import ddp_synthetic, dlrm, resnet

        w = torch.randn(5, 3).to(torch.bfloat16)
        Snapshot.take({str(tmp_path / "snap")!r}, {{"m": StateDict(w=w), "rng": RNGState()}})
        target = StateDict(w=torch.zeros(5, 3, dtype=torch.bfloat16))
        Snapshot({str(tmp_path / "snap")!r}).restore({{"m": target, "rng": RNGState()}})
        assert torch.equal(target["w"].view(torch.int16), w.view(torch.int16))
        Snapshot.async_take({str(tmp_path / "async")!r}, {{"m": StateDict(w=w)}}).wait()
        mgr = CheckpointManager({str(tmp_path / "run")!r}, max_to_keep=1)
        mgr.save(1, {{"m": StateDict(w=w)}})
        mgr.async_save(2, {{"m": StateDict(w=w)}}).wait()
        assert mgr.all_steps() == [2]
        # A streamed restore through the pool, the pipeline and the profile.
        import os
        os.environ["TPUSNAPSHOT_PARALLEL_READ_THRESHOLD"] = str(64 << 10)
        big = torch.randn(1 << 16)
        Snapshot.take({str(tmp_path / "big")!r}, {{"m": StateDict(w=big)}})
        target = StateDict(w=torch.zeros(1 << 16))
        Snapshot({str(tmp_path / "big")!r}).restore({{"m": target}})
        assert torch.equal(target["w"], big)
        assert staging_pool.get_staging_pool() is not None
        assert isinstance(consume_profile.ConsumeProfile().summary(), dict)
        # Deduplication: fingerprints, an incremental take, the chunk
        # store with its codecs (zstd absent), compression, delete's GC.
        assert "zstd" not in codecs.available_codecs()
        run = {str(tmp_path / "dedup")!r}
        state = {{"m": StateDict(w=w, big=big)}}
        base = Snapshot.take(run + "/s1", state, fingerprint=True, compression="zlib")
        Snapshot.take(run + "/s2", state, base=base)
        Snapshot.take(run + "/s3", state, chunks=True, codec={{"m/big": "int8", "*": "zlib"}})
        target = StateDict(w=torch.zeros(5, 3, dtype=torch.bfloat16), big=torch.zeros(1 << 16))
        Snapshot(run + "/s2").restore({{"m": target}}, verify_device=True)
        assert torch.equal(target["big"], big)
        Snapshot(run + "/s3").restore({{"m": target}})
        assert (target["big"] - big).abs().max() <= codecs.quant_error_bound(big)
        Snapshot(run + "/s3").delete()
        # The rest of the API: verify, diff, a partial restore, copy_to,
        # and the inspect CLI's --verify, all without PyYAML.
        assert Snapshot(run + "/s2").verify() == {{}}
        assert Snapshot(run + "/s2").diff(run + "/s1")["unchanged"] == ["m/big", "m/w"]
        Snapshot(run + "/s2").restore({{"m": target}}, paths=["m/w"])
        Snapshot(run + "/s2").copy_to(run + "/copy")
        assert inspect.main([run + "/copy", "--verify"]) == 0
        # The other workloads and the reference format: a DLRM take, its
        # convert_back (JSON metadata) and a reader restore, a bfloat16
        # leaf included, with PyYAML and ml_dtypes blocked.
        cfg = dlrm.DLRMConfig(table_rows={{"a": 16, "b": 8}}, embed_dim=4, dense_in=3, bag_len=2,
                              bottom_mlp=(8, 4), top_mlp=(4, 1))
        params = dlrm.init_params(cfg, seed=0, device="cpu")
        state = dlrm.DLRMState(params, dlrm.init_momentum(params))
        dlrm.sgd_momentum_train_step(state.params, state.momentum,
                                     *dlrm.synthetic_batch(cfg, 4, seed=1, device="cpu"), cfg)
        Snapshot.take(run + "/dlrm", {{"model": state, "extra": StateDict(w=w)}})
        convert_back(run + "/dlrm", run + "/ref")
        assert open(run + "/ref/.snapshot_metadata").read().startswith("{{")
        other = dlrm.init_params(cfg, seed=1, device="cpu")
        back = dlrm.DLRMState(other, dlrm.init_momentum(other))
        extra = StateDict(w=torch.zeros(5, 3, dtype=torch.bfloat16))
        interop.ReferenceSnapshotReader(run + "/ref").restore({{"model": back, "extra": extra}})
        assert torch.equal(back.params["tables"]["a"], state.params["tables"]["a"])
        assert torch.equal(extra["w"].view(torch.int16), w.view(torch.int16))
        assert inspect.main([run + "/dlrm", "--convert-back", run + "/ref2"]) == 0
        rparams, rstats = resnet.init_state(resnet.ResNetConfig(widths=(4,), image_size=4), seed=0, device="cpu")
        synthetic = ddp_synthetic.SyntheticModel(n_params=2, param_bytes=64, device="cpu")
        fn, args = dryrun.entry(device="cpu")
        assert fn(*args).shape == (2, 16, 64)
        # Fault injection: one crash point of a manager cycle, recovered.
        from torchsnapshot_tpu_torch import faultline
        os.environ["TPUSNAPSHOT_SWEEP_MIN_AGE_S"] = "0"
        crash_base = run + "/crash"
        CheckpointManager(crash_base, max_to_keep=1).save(0, {{"m": StateDict(w=w)}})
        with faultline.inject(faultline.FaultSchedule().crash_at(3)) as ctl:
            try:
                CheckpointManager(crash_base, max_to_keep=1).save(1, {{"m": StateDict(w=w)}})
            except faultline.SimulatedCrash:
                pass
        assert ctl.crashed

        def probe(step):
            t = StateDict(w=torch.zeros(5, 3, dtype=torch.bfloat16))
            CheckpointManager(crash_base).restore({{"m": t}}, step=step)
            assert torch.equal(t["w"].view(torch.int16), w.view(torch.int16))

        faultline.check_recovery_invariant(crash_base, probe)
        CheckpointManager(crash_base, max_to_keep=1).save(2, {{"m": StateDict(w=w)}})
        CheckpointManager(crash_base).reconcile(adopt=True)
        faultline.assert_reclaimed(crash_base, [2])
        # Telemetry: the thirteen ported modules, a traced take and
        # restore whose reports the doctor, the timeline and the SLO
        # engine read, memwatch's host figures without psutil.
        from torchsnapshot_tpu_torch import tracing
        from torchsnapshot_tpu_torch.telemetry import (
            doctor, export, goodput, ledger, memwatch, metrics, progress, report, slo,
            summarize, timeline,
        )
        import torchsnapshot_tpu_torch.telemetry as telemetry_pkg
        trace = run + "/trace.json"
        tracing.enable(trace)
        tel = run + "/tel"
        Snapshot.take(tel, {{"m": StateDict(w=w)}})
        Snapshot(tel).restore({{"m": StateDict(w=torch.zeros(5, 3, dtype=torch.bfloat16))}})
        tracing.flush()
        tracing.disable()
        assert summarize.main([trace]) == 0
        assert inspect.main([tel, "--report"]) == 0
        assert inspect.main([tel, "--doctor"]) in (0, 1)
        assert inspect.main([tel, "--timeline"]) in (0, 1)
        assert len(ledger.read_records(tel)[0]) == 2
        assert memwatch.process_rss_bytes() is None
        assert slo.evaluate(records=ledger.read_records(tel)[0])["findings"] is not None
        assert goodput.has_data() and telemetry_pkg.snapshot()
        # The hot tier: an in-process wire peer, an async take acked at
        # k = 2, its drain and a restore served from peer RAM.
        from torchsnapshot_tpu_torch import hottier, wire, wiretap
        from torchsnapshot_tpu_torch.hottier import peer as hpeer, plugin, repair, runtime, tier, transport
        server, _ = hpeer.start_local_peer(1)
        with hottier.hot_tier(rank=0, world=2, k=2, drain="manual", repair="manual"):
            Snapshot.async_take(run + "/hot", {{"m": StateDict(w=w)}}).wait()
            hottier.repair_tick()
            hottier.drain_now()
            t = StateDict(w=torch.zeros(5, 3, dtype=torch.bfloat16))
            Snapshot(run + "/hot").restore({{"m": t}})
            assert torch.equal(t["w"].view(torch.int16), w.view(torch.int16))
            assert hottier.runtime().stats_snapshot()["hot_objects"] == 1
        server.stop()
        hottier.reset_hot_tier()
        assert wiretap.summary()["snapwire/put"]["count"] >= 1
        # The read plane: a RemoteSnapshot restore through an in-process
        # server and a 2-member fleet, a chunk-stored leaf restored
        # through both, and the rest of telemetry (watch, merge, sampler,
        # ops) over them.
        from torchsnapshot_tpu_torch import RemoteSnapshot, snapserve
        from torchsnapshot_tpu_torch.snapserve import cache, client, fleet, protocol, pushdown, remote
        from torchsnapshot_tpu_torch.telemetry import merge, ops, sampler, watch
        os.environ["TPUSNAPSHOT_CHUNK_BYTES"] = "4096"
        Snapshot.take(run + "/served", {{"m": StateDict(w=w, big=big)}}, chunks=True)
        srv = snapserve.start_local_server()
        lf = fleet.start_local_fleet(n=2)
        sampler.start(statusfile_dir=run + "/scope", interval_s=0.05)
        for addr in (srv.addr, lf.addr_spec):
            t = StateDict(w=torch.zeros(5, 3, dtype=torch.bfloat16), big=torch.zeros(1 << 16))
            RemoteSnapshot(run + "/served", addr=addr).restore({{"m": t}})
            assert torch.equal(t["big"], big)
        sampler.stop()
        assert snapserve.stats_snapshot()["fallback_objects"] == 0
        assert snapserve.fetch_server_stats(srv.addr)["requests"] > 0
        assert ops.main(["--wire", srv.addr]) == 0
        assert ops.main([run + "/scope"]) in (0, 1)
        assert watch.main([run + "/served"]) in (0, 1, 2)
        lf.stop()
        srv.stop()
        # An example script, with optax blocked too.
        import runpy
        sys.argv = ["simple_example.py", "--device", "cpu", "--work-dir", run + "/example"]
        runpy.run_path({str(ROOT / "examples_torch" / "simple_example.py")!r}, run_name="__main__")
        assert not BLOCKED & set(m.split(".")[0] for m in set(sys.modules) - PRESENT)
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_peer_process_imports_no_jax_and_no_optional_packages(tmp_path):
    """``python -m torchsnapshot_tpu_torch.hottier.peer`` binds, acks a
    fingerprint-verified put and serves it back with JAX, the JAX
    package, PyYAML and psutil blocked. Every import of them it attempts
    is logged as it happens (the process is killed, as a lost host is):
    JAX and the JAX package never are; psutil only where memwatch asks
    for it optionally (host RSS, absent on the card's machine)."""
    import time

    import numpy as np

    from torchsnapshot_tpu_torch.fingerprint import fingerprint_host
    from torchsnapshot_tpu_torch.hottier.transport import RemotePeer

    attempts, port_file = tmp_path / "attempts.log", tmp_path / "peer.addr"
    script = textwrap.dedent(
        f"""
        import importlib.abc, runpy, sys

        BLOCKED = {{"yaml", "psutil", "jax", "jaxlib", "torchsnapshot_tpu"}}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    with open({str(attempts)!r}, "a") as f:
                        f.write(name + "\\n")
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        sys.argv = ["peer", "--host-id", "3", "--addr", "127.0.0.1:0",
                    "--port-file", {str(port_file)!r}]
        runpy.run_module("torchsnapshot_tpu_torch.hottier.peer", run_name="__main__")
        """
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE
    )
    try:
        deadline = time.monotonic() + 120.0
        while not port_file.exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline, "the peer did not bind"
            time.sleep(0.05)
        peer = RemotePeer(host_id=3, addr=port_file.read_text().strip())
        try:
            data = np.arange(4096, dtype=np.float32).tobytes()
            key, root = "memory://blocked/run/step_0/0/s/w", "memory://blocked/run/step_0"
            stored, tag = peer.put(key, data, tag=fingerprint_host(data), root=root)
            assert stored and tag == fingerprint_host(data)
            assert peer.get(key).data == data
            assert peer.probe()
            assert peer.wire_stats() is not None and peer.mem_stats() is not None
        finally:
            peer.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)
    tried = set(attempts.read_text().split()) if attempts.exists() else set()
    assert tried <= {"psutil"}, tried


def test_server_process_imports_no_jax_and_no_optional_packages(tmp_path):
    """``python -m torchsnapshot_tpu_torch.snapserve.server`` binds and
    serves a restore with JAX, the JAX package, PyYAML, psutil and
    ml_dtypes blocked; every import of them it attempts is logged (the
    process is killed at the end): none but psutil, which memwatch asks
    for optionally."""
    import time

    import torch

    from torchsnapshot_tpu_torch import RemoteSnapshot, Snapshot, StateDict

    attempts, port_file = tmp_path / "attempts.log", tmp_path / "server.addr"
    w = torch.arange(4096, dtype=torch.float32)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(w=w)})
    script = textwrap.dedent(
        f"""
        import importlib.abc, runpy, sys

        BLOCKED = {{"yaml", "psutil", "ml_dtypes", "jax", "jaxlib", "torchsnapshot_tpu"}}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    with open({str(attempts)!r}, "a") as f:
                        f.write(name + "\\n")
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        sys.argv = ["server", "--addr", "127.0.0.1:0", "--port-file", {str(port_file)!r}]
        runpy.run_module("torchsnapshot_tpu_torch.snapserve.server", run_name="__main__")
        """
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE
    )
    try:
        deadline = time.monotonic() + 120.0
        while not (port_file.exists() and port_file.read_text().strip()):
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline, "the server did not bind"
            time.sleep(0.05)
        addr = port_file.read_text().strip()
        target = StateDict(w=torch.zeros(4096))
        RemoteSnapshot(str(tmp_path / "snap"), addr=addr).restore({"m": target})
        assert torch.equal(target["w"], w)
    finally:
        proc.kill()
        proc.wait(timeout=10)
    tried = set(attempts.read_text().split()) if attempts.exists() else set()
    assert tried <= {"psutil"}, tried


def test_analysis_cli_runs_with_optional_packages_blocked(tmp_path):
    """``python -m torchsnapshot_tpu_torch.analysis`` (the package and its
    ``__main__``) lists its rules, renders the protocol inventory and
    checks a tree with JAX, the JAX package, PyYAML, psutil, ml_dtypes,
    zstandard and the cloud SDKs blocked, as on the card's machine. Every
    import of them it attempts is logged: none but psutil, which
    memwatch asks for optionally when the port's package loads."""
    attempts = tmp_path / "attempts.log"
    fixture = ROOT / "tests" / "torch_analysis_fixtures" / "good_torch_sync.py"
    script = textwrap.dedent(
        f"""
        import contextlib, importlib.abc, io, json, runpy, sys

        BLOCKED = {{"yaml", "psutil", "ml_dtypes", "jax", "jaxlib", "optax", "torchsnapshot_tpu",
                   "zstandard", "boto3", "aiobotocore", "google"}}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    with open({str(attempts)!r}, "a") as f:
                        f.write(name + "\\n")
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})

        def cli(*argv):
            sys.argv = ["snapcheck", *argv]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                try:
                    runpy.run_module("torchsnapshot_tpu_torch.analysis", run_name="__main__")
                except SystemExit as e:
                    return e.code, out.getvalue()
            return None, out.getvalue()

        rc, out = cli("--list-rules")
        assert rc == 0 and out.count("SNAP0") == 13, (rc, out)
        rc, out = cli("--inventory")
        assert rc == 0 and out.startswith("# Wire-protocol inventory"), rc
        rc, out = cli("--format", "json", {str(fixture)!r},
                      {str(ROOT / "torchsnapshot_tpu_torch" / "analysis")!r})
        assert rc == 0 and json.loads(out)["ok"] is True, (rc, out)
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    tried = set(attempts.read_text().split()) if attempts.exists() else set()
    assert tried <= {"psutil"}, tried
