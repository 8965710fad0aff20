"""The check that a run loads nothing of JAX and the reference nothing of the program."""

import sys
import types

from perfbench import guard


def test_whole_top_level_names_are_compared(monkeypatch):
    assert guard.loaded_blocked() == []
    monkeypatch.setitem(sys.modules, "torchsnapshot_tpu_torch_extra", types.ModuleType("x"))
    assert guard.loaded_blocked() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "torchsnapshot_tpu.snapshot", types.ModuleType("y"))
    assert guard.loaded_blocked() == ["jax", "torchsnapshot_tpu"]
    assert len(guard.check("test")) == 2


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_violations() == []


def test_imported_names_catches_program_imports(tmp_path):
    path = tmp_path / "ref.py"
    path.write_text("import torch\nfrom torchsnapshot_tpu_torch.models import dlrm\nfrom .. import x\nfrom . import tf32\n")
    names = guard.imported_names(path)
    assert {"torchsnapshot_tpu_torch", "perfbench", "torch"} <= set(names)
    assert set(names) & guard.REFERENCE_BLOCKED == {"torchsnapshot_tpu_torch", "perfbench"}
