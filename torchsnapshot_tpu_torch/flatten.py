"""Reversible tree flattening to slash-delimited logical paths.

``flatten``
converts a nested container (dict / OrderedDict / list / tuple) into

- a *manifest* of container entries describing the tree structure, and
- a flat ``{slash/path: leaf}`` dict of leaves,

such that ``inflate(manifest, flattened)`` reproduces the original object.
Leaves are anything that is not a flattenable container: ``torch.Tensor``,
``numpy.ndarray``, scalars, or arbitrary objects. The logical paths are
the ones the JAX package derives for the same tree, so one snapshot's
manifest reads the same from either package.

Dict flattening rules:

- keys must all be ``str`` or ``int``;
- the string representations of the keys must not collide;
- no string key may contain ``"/"`` (the path separator); such a dict
  is treated as an opaque leaf instead.

``inflate`` places list/tuple elements by *numeric index* rather than by
lexicographic path order, so lists with more than ten elements keep their
order. Tuples are recorded as ``TupleEntry`` and rebuilt as tuples.
"""

from collections import OrderedDict
from typing import Any, Dict, Tuple

from .manifest import (
    DictEntry,
    Entry,
    ListEntry,
    Manifest,
    OrderedDictEntry,
    TupleEntry,
)

_FLATTENABLE_DICTS = (dict, OrderedDict)
_FLATTENABLE_SEQS = (list, tuple)


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def _should_flatten_dict(d: Dict[Any, Any]) -> bool:
    if not all(isinstance(k, (str, int)) for k in d.keys()):
        return False
    str_keys = {str(k) for k in d.keys()}
    if len(str_keys) < len(d):
        return False
    if any("/" in k for k in str_keys):
        return False
    return True


def flatten(obj: Any, prefix: str = "") -> Tuple[Manifest, Dict[str, Any]]:
    """Recursively flatten ``obj``; returns (container manifest, leaves)."""
    manifest: Manifest = {}
    flattened: Dict[str, Any] = {}
    typ = type(obj)
    if typ is list or typ is tuple:
        manifest[prefix] = ListEntry() if typ is list else TupleEntry()
        for idx, elem in enumerate(obj):
            m, f = flatten(elem, _join(prefix, str(idx)))
            manifest.update(m)
            flattened.update(f)
    elif typ in _FLATTENABLE_DICTS and _should_flatten_dict(obj):
        keys = list(obj.keys())
        if typ is dict:
            manifest[prefix] = DictEntry(keys=keys)
        else:
            manifest[prefix] = OrderedDictEntry(keys=keys)
        for key, elem in obj.items():
            m, f = flatten(elem, _join(prefix, str(key)))
            manifest.update(m)
            flattened.update(f)
    else:
        flattened[prefix] = obj
    return manifest, flattened


def _make_container(entry: Entry) -> Any:
    if isinstance(entry, ListEntry) and not isinstance(entry, TupleEntry):
        return []
    if isinstance(entry, TupleEntry):
        return []  # built as list, converted to tuple in a final pass
    if isinstance(entry, OrderedDictEntry):
        return OrderedDict.fromkeys(entry.keys)
    if isinstance(entry, DictEntry):
        return dict.fromkeys(entry.keys)
    raise RuntimeError(
        f"Unrecognized container entry type: {type(entry)} ({entry.type})."
    )


def _check_int(s: str) -> bool:
    if s.isdigit():
        return True
    if len(s) > 1 and s[0] in ("-", "+"):
        return s[1:].isdigit()
    return False


def inflate(manifest: Manifest, flattened: Dict[str, Any], prefix: str = "") -> Any:
    """Reverse of :func:`flatten`."""
    for path in list(manifest.keys()) + list(flattened.keys()):
        if prefix and not (path == prefix or path.startswith(prefix + "/") or prefix == ""):
            if not path.startswith(prefix):
                raise RuntimeError(f"{path} does not start with {prefix}")

    def trim(path: str) -> str:
        if prefix:
            return "/" + path[len(prefix):].lstrip("/")
        return "/" + path

    combined: Dict[str, Any] = {}
    tuple_paths = set()
    for path, entry in manifest.items():
        combined[trim(path)] = _make_container(entry)
        if isinstance(entry, TupleEntry):
            tuple_paths.add(trim(path))
    for path, obj in flattened.items():
        combined[trim(path)] = obj

    # Fill parents. Sort by (depth, numeric-aware tokens) so containers fill
    # deterministically and list indices land in numeric order.
    def sort_key(path: str):
        tokens = path.split("/")
        return [
            (0, int(t), "") if _check_int(t) else (1, 0, t) for t in tokens
        ]

    for path in sorted(combined.keys(), key=sort_key):
        if path == "/":
            continue
        val = combined[path]
        tokens = path.split("/")
        dir_path = "/".join(tokens[:-1]) or "/"
        if dir_path not in combined:
            raise RuntimeError(f'Container entry is absent for "{dir_path}"')
        container = combined[dir_path]
        key = tokens[-1]
        if isinstance(container, list):
            idx = int(key)
            if idx != len(container):
                raise RuntimeError(
                    f"List element {path} arrived out of order "
                    f"(index {idx}, expected {len(container)})."
                )
            container.append(val)
        elif isinstance(container, _FLATTENABLE_DICTS):
            if key in container:
                container[key] = val
            elif _check_int(key) and int(key) in container:
                container[int(key)] = val
            else:
                raise RuntimeError(f"Item {path} is not listed in the manifest.")
        else:
            raise RuntimeError(
                f'"{dir_path}" is not a container (got {type(container)}).'
            )

    # Convert tuple placeholders bottom-up (children first: longer paths
    # were filled into their parents by reference, so rebuild parents).
    for path in sorted(tuple_paths, key=lambda p: -len(p.split("/"))):
        as_tuple = tuple(combined[path])
        combined[path] = as_tuple
        if path != "/":
            tokens = path.split("/")
            dir_path = "/".join(tokens[:-1]) or "/"
            parent = combined[dir_path]
            key = tokens[-1]
            if isinstance(parent, list):
                parent[int(key)] = as_tuple
            elif isinstance(parent, _FLATTENABLE_DICTS):
                if key in parent:
                    parent[key] = as_tuple
                else:
                    parent[int(key)] = as_tuple

    return combined["/"]
