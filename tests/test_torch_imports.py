"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and it runs where PyYAML, psutil, ml_dtypes and zstandard are not
installed (the machine with the card has none of them)."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "torchsnapshot_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN_ANYWHERE = {"jax", "jaxlib", "torchsnapshot_tpu"}
FORBIDDEN_AT_MODULE_LEVEL = {"yaml", "psutil", "ml_dtypes", "triton", "zstandard"}


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

        BLOCKED = {{"yaml", "psutil", "ml_dtypes", "jax", "jaxlib", "torchsnapshot_tpu", "zstandard"}}

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
        assert not BLOCKED & set(m.split(".")[0] for m in sys.modules)
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
