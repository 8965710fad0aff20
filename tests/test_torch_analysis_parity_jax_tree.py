"""The port's snapcheck over the JAX package's own tree gives what the JAX
package's snapcheck gives: the same findings (none: that tree is gated
clean), the same suppressed findings, no unparseable file.

The torch registry could tell them apart only at a PyTorch host sync the
JAX tree calls. It calls three, all in ``interop/_torch_convert.py``
(``t.cpu()`` and two ``.numpy()``), in sync code that no ``async def``
reaches, so neither SNAP001 nor SNAP007's transitive arm fires there and
the allowed difference below is empty. ``test_torch_analysis_parity.py``
holds the corpus, the port's tree and the inventories.
"""

import ast
import os

import pytest

from torchsnapshot_tpu import analysis as jax_analysis
from torchsnapshot_tpu_torch import analysis as port_analysis
from torchsnapshot_tpu_torch.analysis.core import import_aliases, imported_names
from torchsnapshot_tpu_torch.analysis.rules_async import torch_sync_name

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
JAX_PACKAGE = os.path.join(os.path.dirname(TESTS_DIR), "torchsnapshot_tpu")
# (relative path, line) of the JAX tree's torch syncs.
TORCH_SYNC_SITES = [
    ("interop/_torch_convert.py", 44),
    ("interop/_torch_convert.py", 51),
    ("interop/_torch_convert.py", 53),
]
# Findings only the port's analyzer may raise on the JAX tree.
ALLOWED_DIFFERENCE = set()


def findings(diags):
    return {
        (d.code, os.path.relpath(d.path, JAX_PACKAGE), d.line, d.col, d.message)
        for d in diags
    }


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX tree under both analyzers, once for the module."""
    paths = [JAX_PACKAGE]
    return (
        port_analysis.run(paths, port_analysis.default_rules()),
        jax_analysis.run(paths, jax_analysis.default_rules()),
    )


def test_same_findings(jax_tree):
    port, jax = jax_tree
    assert findings(port.violations) - findings(jax.violations) == (
        ALLOWED_DIFFERENCE
    )
    assert findings(jax.violations) <= findings(port.violations)
    assert port.ok and jax.ok


def test_same_suppressed_findings(jax_tree):
    port, jax = jax_tree
    assert findings(port.suppressed) == findings(jax.suppressed)
    assert len(port.suppressed) == len(jax.suppressed) == 46


def test_no_unparseable_file(jax_tree):
    port, jax = jax_tree
    assert port.errors == jax.errors == []


def test_torch_sync_sites_are_the_listed_ones():
    sites = []
    for path in port_analysis.iter_python_files([JAX_PACKAGE]):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        aliases = import_aliases(tree, "torch")
        bare = {n for n in imported_names(tree, "torch") if n == "synchronize"}
        sites.extend(
            (os.path.relpath(path, JAX_PACKAGE), node.lineno)
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and torch_sync_name(node.func, aliases, bare) is not None
        )
    assert sorted(sites) == TORCH_SYNC_SITES
