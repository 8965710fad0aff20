"""The port's snapcheck held against the JAX package's.

The port keeps its own copy of the analyzer (``torchsnapshot_tpu_torch/
analysis/``, stdlib only) and adds PyTorch's host syncs to SNAP001 and
SNAP007. Everything else must read the same from either package:

- on every file of the shared corpus ``tests/analysis_fixtures/``, the
  same findings — (code, relative path, line, column, message) — and the
  same suppressed ones;
- on the port's tree, the JAX analyzer's findings are a subset of the
  port analyzer's, the same suppressions honoured, and any extra finding
  names a torch sync (today there is none: the port's gate is clean);
- the two ``build_inventory`` dicts are equal but for the source lines
  that send an op (the port's copy of a module may be laid out
  otherwise), and so are the markdown renderings but for the line naming
  the CLI; either model reads either tree identically.

The JAX package's own tree is compared in
``test_torch_analysis_parity_jax_tree.py``. Only these two files import
the JAX package's analyzer.
"""

import os

import pytest

from torchsnapshot_tpu import analysis as jax_analysis
from torchsnapshot_tpu.analysis import protocol as jax_protocol
from torchsnapshot_tpu_torch import analysis as port_analysis
from torchsnapshot_tpu_torch.analysis import protocol as port_protocol
from torchsnapshot_tpu_torch.analysis.rules_async import TORCH_SYNC_METHODS

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
FIXTURES = os.path.join(TESTS_DIR, "analysis_fixtures")
PORT_PACKAGE = os.path.join(REPO_ROOT, "torchsnapshot_tpu_torch")
JAX_PACKAGE = os.path.join(REPO_ROOT, "torchsnapshot_tpu")
# The JAX package's gate allows this many suppressions in all; the
# port's copies of its modules may not need more.
JAX_SUPPRESSIONS = 46

FIXTURE_FILES = sorted(
    os.path.relpath(p, FIXTURES)
    for p in port_analysis.iter_python_files([FIXTURES])
)


def findings(diags, root):
    return {
        (d.code, os.path.relpath(d.path, root), d.line, d.col, d.message)
        for d in diags
    }


def both(paths):
    return (
        port_analysis.run(paths, port_analysis.default_rules()),
        jax_analysis.run(paths, jax_analysis.default_rules()),
    )


def names_a_torch_sync(message):
    return "torch.cuda.synchronize()" in message or any(
        f".{name}()'" in message for name in TORCH_SYNC_METHODS
    )


# ------------------------------------------------------------ the corpus


@pytest.mark.parametrize("rel", FIXTURE_FILES)
def test_fixture_findings_match(rel):
    port, jax = both([os.path.join(FIXTURES, rel)])
    assert findings(port.violations, FIXTURES) == findings(
        jax.violations, FIXTURES
    )
    assert findings(port.suppressed, FIXTURES) == findings(
        jax.suppressed, FIXTURES
    )
    assert port.errors == jax.errors


def test_corpus_findings_match_as_one_run():
    # Cross-file rules (SNAP009's docs, SNAP010's sibling modules) see
    # the whole corpus at once here.
    port, jax = both([FIXTURES])
    assert findings(port.violations, FIXTURES) == findings(
        jax.violations, FIXTURES
    )
    assert len(port.suppressed) == len(jax.suppressed)
    assert {d.code for d in port.violations} == {
        r.code for r in port_analysis.default_rules()
    }


# ------------------------------------------------------------ the port


@pytest.fixture(scope="module")
def port_tree():
    """The port's tree under both analyzers, once for the module."""
    return both([PORT_PACKAGE])


def test_port_tree_is_clean_under_both(port_tree):
    port, jax = port_tree
    assert port.ok, "\n".join(d.format() for d in port.violations)
    extra = findings(jax.violations, PORT_PACKAGE) - findings(
        port.violations, PORT_PACKAGE
    )
    assert extra == set()
    assert jax.ok and not jax.errors


def test_port_tree_jax_findings_are_a_subset(port_tree):
    port, jax = port_tree
    port_all = findings(port.violations + port.suppressed, PORT_PACKAGE)
    jax_all = findings(jax.violations + jax.suppressed, PORT_PACKAGE)
    assert jax_all <= port_all
    # The same suppressions honoured: what the JAX analyzer silences,
    # the port's silences too.
    assert findings(jax.suppressed, PORT_PACKAGE) <= findings(
        port.suppressed, PORT_PACKAGE
    )
    # What only the port's analyzer sees is a torch sync.
    for extra in sorted(port_all - jax_all):
        assert extra[0] in ("SNAP001", "SNAP007"), extra
        assert names_a_torch_sync(extra[4]), extra


def test_port_tree_suppressions_within_the_jax_count(port_tree):
    port, _ = port_tree
    assert len(port.suppressed) <= JAX_SUPPRESSIONS
    # The only suppression of a torch sync: a lease's host buffer read as
    # numpy on the restore's consume path.
    torch_sync_suppressions = [
        (os.path.relpath(d.path, PORT_PACKAGE), d.code)
        for d in port.suppressed
        if names_a_torch_sync(d.message)
    ]
    assert torch_sync_suppressions == [("io_preparer.py", "SNAP007")]


# ------------------------------------------------------- the inventories


def protocol_of(inventory):
    """An inventory without its source positions: ``sent_by`` maps each
    sending file to the lines that send the op, and a line of the port's
    copy of a module may sit elsewhere than the JAX package's. The files
    that send each op stay."""
    def strip(node):
        if isinstance(node, dict):
            return {
                k: sorted(v) if k == "sent_by" else strip(v)
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    return strip(inventory)


def test_inventories_are_equal():
    port = port_protocol.build_inventory()
    jax = jax_protocol.build_inventory()
    assert protocol_of(port) == protocol_of(jax)
    # Where they differ at all, it is a line number in ``sent_by``.
    assert port.keys() == jax.keys() and port["wire"] == jax["wire"]


def test_inventory_of_each_package_under_either_model():
    # Each package's model reads the other's tree the same way, line
    # numbers included.
    for root in (PORT_PACKAGE, JAX_PACKAGE):
        assert port_protocol.build_inventory(
            root
        ) == jax_protocol.build_inventory(root), root


def test_renderings_differ_only_in_the_cli_line():
    port_md = port_protocol.render_markdown(port_protocol.build_inventory())
    jax_md = jax_protocol.render_markdown(jax_protocol.build_inventory())
    differ = [
        (a, b)
        for a, b in zip(port_md.splitlines(), jax_md.splitlines())
        if a != b
    ]
    assert len(port_md.splitlines()) == len(jax_md.splitlines())
    assert len(differ) == 1
    port_line, jax_line = differ[0]
    assert "python -m torchsnapshot_tpu_torch.analysis --inventory" in port_line
    assert port_line.replace("torchsnapshot_tpu_torch", "torchsnapshot_tpu") == (
        jax_line
    )
