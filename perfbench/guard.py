"""Checks that a run measures the PyTorch port and nothing of JAX.

Names are compared whole, by the part before the first dot: the port,
``torchsnapshot_tpu_torch``, begins with the JAX package's name.
"""

import ast
import sys
from pathlib import Path
from typing import List

BLOCKED = frozenset({"jax", "jaxlib", "flax", "torchsnapshot_tpu"})
# What the plain references may not import: the program, JAX, or the
# benchmark's own modules (which load the program); a reference may import
# its siblings in perfbench/reference/.
REFERENCE_BLOCKED = BLOCKED | {"torchsnapshot_tpu_torch", "perfbench"}
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def loaded_blocked() -> List[str]:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & BLOCKED)


def imported_names(path: Path) -> List[str]:
    """Top-level names of every module that a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level > 1:
                names.add("perfbench")  # reaches out of its folder into the benchmark
            elif node.module and not node.level:
                names.add(node.module.split(".")[0])
    return sorted(names)


def reference_violations() -> List[str]:
    """``file: name`` for each blocked import in ``perfbench/reference/``."""
    found = []
    for path in sorted(REFERENCE_DIR.glob("*.py")):
        found += [f"{path.name}: {name}" for name in imported_names(path) if name in REFERENCE_BLOCKED]
    return found


def check(when: str) -> List[str]:
    """Everything wrong, as lines for standard error."""
    problems = [f"{when}: module {name} is loaded" for name in loaded_blocked()]
    problems += [f"{when}: perfbench/reference imports {v}" for v in reference_violations()]
    return problems
