"""Tree ⇄ plain-container conversion helpers.

Statefuls feed :mod:`torchsnapshot_tpu_torch.flatten` with plain
containers. Other trees (NamedTuple optimizer states, nested tuples with
``None`` holes) convert through these helpers: ``to_state_dict`` turns a
tree of dicts, lists, tuples and NamedTuples into nested plain dicts, and
``from_state_dict`` pours such a dict back into a template's structure.

The key strings are the JAX package's (``jax.tree_util`` key paths as
``_key_str`` prints them), so one tree gives the same logical paths in
both packages: dict keys in sorted order (an ``OrderedDict`` keeps its
own), sequence indices, NamedTuple field names; ``None`` holds no leaf;
a bare leaf is stored under ``"value"``.
"""

from collections import OrderedDict
from typing import Any, Dict, Iterator, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _dict_keys(node: dict) -> list:
    return list(node) if isinstance(node, OrderedDict) else sorted(node)


def _children(node: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for key in _dict_keys(node):
            yield str(key), node[key]
    elif _is_namedtuple(node):
        for name in node._fields:
            yield name, getattr(node, name)
    else:
        for i, val in enumerate(node):
            yield str(i), val


def _is_container(node: Any) -> bool:
    return isinstance(node, (dict, list, tuple))


def _leaves_with_paths(node: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if node is None:
        return
    if not _is_container(node):
        yield path, node
        return
    for key, child in _children(node):
        yield from _leaves_with_paths(child, path + (key,))


def to_state_dict(tree: Any) -> Dict[str, Any]:
    """Nested plain dicts of ``tree``'s leaves, keyed by path component."""
    out: Dict[str, Any] = {}
    for path, leaf in _leaves_with_paths(tree):
        node = out
        keys = list(path) or ["value"]
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return out


def from_state_dict(tree_template: Any, state_dict: Dict[str, Any]) -> Any:
    """Inverse of :func:`to_state_dict`: ``tree_template``'s structure
    with the state dict's leaves (plain dicts rebuilt in sorted key
    order, as ``jax.tree_util`` rebuilds them)."""

    def build(node: Any, path: Tuple[str, ...]) -> Any:
        if node is None:
            return None
        if not _is_container(node):
            found: Any = state_dict
            for key in list(path) or ["value"]:
                found = found[key]
            return found
        if isinstance(node, dict):
            rebuilt = [(k, build(node[k], path + (str(k),))) for k in _dict_keys(node)]
            return OrderedDict(rebuilt) if isinstance(node, OrderedDict) else dict(rebuilt)
        values = [build(child, path + (key,)) for key, child in _children(node)]
        if _is_namedtuple(node):
            return type(node)(*values)
        return type(node)(values)

    return build(tree_template, ())
