"""Typed manifest entries and snapshot metadata (shared on-disk format).

The manifest maps logical paths (``"<rank>/<stateful_key>/<flattened/path>"``)
to typed entries describing either containers (dict/list/...) or persisted
values:

- ``ArrayEntry`` — a dense array persisted as one storage object of raw
  little-endian bytes; dtype/shape live here.
- ``ShardedArrayEntry`` — an array persisted as several ``Shard`` boxes
  (global ``offsets``/``sizes``), each its own ``ArrayEntry``: a JAX
  mesh-sharded array, or a dense array above the chunk cap.
- ``ObjectEntry`` — an arbitrary picklable leaf.
- ``PrimitiveEntry`` — a small scalar stored inline in the manifest.
- container entries (``DictEntry``/``OrderedDictEntry``/``ListEntry``/
  ``TupleEntry``) — structure only.

``SnapshotMetadata`` is the document at ``<snapshot>/.snapshot_metadata``.
It is written as JSON (a subset of YAML) exactly as the JAX package
writes it, so either package reads the other's snapshots. A document in
full YAML syntax is read only when PyYAML is installed.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


@dataclass
class Entry:
    """Base class; ``type`` tags the concrete entry."""

    type: str


@dataclass
class ArrayEntry(Entry):
    location: str
    serializer: str  # "raw" (little-endian C-order payload)
    dtype: str  # canonical name, e.g. "bfloat16"
    shape: List[int]
    replicated: bool
    # JAX PRNG key arrays: the impl name; the payload is the uint32 key
    # data. The port restores such leaves as that raw key data.
    prng_impl: Optional[str] = None
    checksum: Optional[str] = None  # "crc32:<hex>" of the stored bytes
    # Compression of the stored payload, its xs128 content fingerprint,
    # the index in ``SnapshotMetadata.base_paths`` of the root that holds
    # it (a base snapshot's, or the chunk store's), and its content-chunk
    # records ({"k": key, "n": bytes, "c": codec, "sn", "cs"}).
    compression: Optional[str] = None
    fingerprint: Optional[str] = None
    base: Optional[int] = None
    chunks: Optional[List[Dict[str, Any]]] = None

    def __init__(
        self,
        location: str,
        serializer: str,
        dtype: str,
        shape: List[int],
        replicated: bool,
        prng_impl: Optional[str] = None,
        checksum: Optional[str] = None,
        compression: Optional[str] = None,
        fingerprint: Optional[str] = None,
        base: Optional[int] = None,
        chunks: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        super().__init__(type="Array")
        self.location = location
        self.serializer = serializer
        self.dtype = dtype
        self.shape = list(shape)
        self.replicated = replicated
        self.prng_impl = prng_impl
        self.checksum = checksum
        self.compression = compression
        self.fingerprint = fingerprint
        self.base = base
        self.chunks = chunks


@dataclass
class Shard:
    offsets: List[int]
    sizes: List[int]
    array: ArrayEntry


@dataclass
class ShardedArrayEntry(Entry):
    dtype: str
    shape: List[int]  # global shape
    shards: List[Shard]
    prng_impl: Optional[str] = None
    # Ownership of a CHUNKED DENSE entry: ``replicated`` or ``per_rank``
    # (the latter for this port's takes). Mesh-sharded entries set neither.
    replicated: bool = False
    per_rank: bool = False

    def __init__(
        self,
        dtype: str,
        shape: List[int],
        shards: List[Shard],
        prng_impl: Optional[str] = None,
        replicated: bool = False,
        per_rank: bool = False,
    ) -> None:
        super().__init__(type="ShardedArray")
        self.dtype = dtype
        self.shape = list(shape)
        self.shards = shards
        self.prng_impl = prng_impl
        self.replicated = replicated
        self.per_rank = per_rank


@dataclass
class ObjectEntry(Entry):
    location: str
    serializer: str  # "pickle"
    replicated: bool
    checksum: Optional[str] = None
    compression: Optional[str] = None

    def __init__(
        self,
        location: str,
        serializer: str,
        replicated: bool,
        checksum: Optional[str] = None,
        compression: Optional[str] = None,
    ) -> None:
        super().__init__(type="object")
        self.location = location
        self.serializer = serializer
        self.replicated = replicated
        self.checksum = checksum
        self.compression = compression


@dataclass
class PrimitiveEntry(Entry):
    ptype: str  # "int" | "float" | "bool" | "str" | "NoneType" | "complex"
    readable: str  # repr() round-trippable representation
    replicated: bool

    def __init__(self, ptype: str, readable: str, replicated: bool) -> None:
        super().__init__(type="primitive")
        self.ptype = ptype
        self.readable = readable
        self.replicated = replicated

    @classmethod
    def from_value(cls, value: Any, replicated: bool = False) -> "PrimitiveEntry":
        ptype = type(value).__name__
        if ptype not in _PRIMITIVE_DECODERS:
            raise TypeError(f"{ptype} is not an inline-primitive type")
        return cls(ptype=ptype, readable=repr(value), replicated=replicated)

    def get_value(self) -> Any:
        return _PRIMITIVE_DECODERS[self.ptype](self.readable)


def _decode_str_repr(s: str) -> str:
    import ast

    return ast.literal_eval(s)


_PRIMITIVE_DECODERS = {
    "int": int,
    "float": float,
    "bool": lambda s: s == "True",
    "str": _decode_str_repr,
    "NoneType": lambda s: None,
    "complex": complex,
}


@dataclass
class ListEntry(Entry):
    def __init__(self) -> None:
        super().__init__(type="list")


@dataclass
class TupleEntry(ListEntry):
    def __init__(self) -> None:
        Entry.__init__(self, type="tuple")


@dataclass
class DictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(type="dict")
        self.keys = keys


@dataclass
class OrderedDictEntry(DictEntry):
    def __init__(self, keys: List[Union[str, int]]) -> None:
        Entry.__init__(self, type="OrderedDict")
        self.keys = keys


Manifest = Dict[str, Entry]


def _array_entry_dict(e: ArrayEntry) -> Dict[str, Any]:
    # The incremental-snapshot fields are omitted when unset, exactly as
    # the JAX package writes them.
    d = dict(e.__dict__)
    for key in ("fingerprint", "base", "chunks"):
        if d.get(key) is None:
            d.pop(key, None)
    return d


def _entry_to_dict(entry: Entry) -> Dict[str, Any]:
    if isinstance(entry, ShardedArrayEntry):
        return {
            "type": entry.type,
            "dtype": entry.dtype,
            "shape": entry.shape,
            "prng_impl": entry.prng_impl,
            "replicated": entry.replicated,
            "per_rank": entry.per_rank,
            "shards": [
                {
                    "offsets": s.offsets,
                    "sizes": s.sizes,
                    "array": _array_entry_dict(s.array),
                }
                for s in entry.shards
            ],
        }
    if isinstance(entry, ArrayEntry):
        return _array_entry_dict(entry)
    return dict(entry.__dict__)


def _array_entry_from_dict(d: Dict[str, Any]) -> ArrayEntry:
    return ArrayEntry(
        location=d["location"],
        serializer=d["serializer"],
        dtype=d["dtype"],
        shape=d["shape"],
        replicated=d["replicated"],
        prng_impl=d.get("prng_impl"),
        checksum=d.get("checksum"),
        compression=d.get("compression"),
        fingerprint=d.get("fingerprint"),
        base=d.get("base"),
        chunks=d.get("chunks"),
    )


def entry_from_dict(d: Dict[str, Any]) -> Entry:
    typ = d["type"]
    if typ == "Array":
        return _array_entry_from_dict(d)
    if typ == "ShardedArray":
        return ShardedArrayEntry(
            dtype=d["dtype"],
            shape=d["shape"],
            shards=[
                Shard(
                    offsets=s["offsets"],
                    sizes=s["sizes"],
                    array=_array_entry_from_dict(s["array"]),
                )
                for s in d["shards"]
            ],
            prng_impl=d.get("prng_impl"),
            replicated=d.get("replicated", False),
            per_rank=d.get("per_rank", False),
        )
    d = dict(d)
    d.pop("type")
    if typ == "object":
        return ObjectEntry(**d)
    if typ == "primitive":
        return PrimitiveEntry(**d)
    if typ == "list":
        return ListEntry()
    if typ == "tuple":
        return TupleEntry()
    if typ == "dict":
        return DictEntry(keys=d["keys"])
    if typ == "OrderedDict":
        return OrderedDictEntry(keys=d["keys"])
    raise ValueError(f"Unknown entry type: {typ}")


def _load_full_yaml(text: str) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            "Snapshot metadata is not JSON, and reading full YAML syntax "
            "needs PyYAML, which is not installed."
        ) from None
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    return yaml.load(text, Loader=loader)


@dataclass
class SnapshotMetadata:
    version: str
    world_size: int
    manifest: Manifest = field(default_factory=dict)
    # Unique id of the take that produced this snapshot.
    take_id: Optional[str] = None
    # Roots the entries' ``base`` indices name: base snapshots and the
    # chunk store, each ``rel:<sibling>`` or ``abs:<url>``.
    base_paths: List[str] = field(default_factory=list)

    def to_yaml(self) -> str:
        doc = {
            "version": self.version,
            "world_size": self.world_size,
            "take_id": self.take_id,
            "manifest": {
                path: _entry_to_dict(entry)
                for path, entry in self.manifest.items()
            },
        }
        if self.base_paths:
            doc["base_paths"] = self.base_paths
        # The JSON subset of YAML, compact and key-sorted: byte-for-byte
        # what the JAX package emits for the same manifest.
        return json.dumps(doc, sort_keys=True)

    @classmethod
    def from_yaml(cls, yaml_str: str) -> "SnapshotMetadata":
        try:
            doc = json.loads(yaml_str)
        except ValueError:
            doc = _load_full_yaml(yaml_str)
        manifest = {
            path: entry_from_dict(d)
            for path, d in (doc.get("manifest") or {}).items()
        }
        return cls(
            version=doc["version"],
            world_size=doc["world_size"],
            manifest=manifest,
            take_id=doc.get("take_id"),
            base_paths=list(doc.get("base_paths") or []),
        )


def entry_has_content(entry: Entry) -> bool:
    """Whether this entry provably describes stored bytes (a payload
    checksum or content-chunk records). Of a replicated value's per-rank
    mirrors, only the writing owner's satisfies this."""
    if isinstance(entry, ShardedArrayEntry):
        return any(
            s.array.checksum is not None or s.array.chunks
            for s in entry.shards
        )
    return (
        getattr(entry, "checksum", None) is not None
        or getattr(entry, "chunks", None) is not None
    )


def is_replicated(entry: Entry) -> bool:
    return (
        isinstance(
            entry,
            (ArrayEntry, ObjectEntry, PrimitiveEntry, ShardedArrayEntry),
        )
        and entry.replicated
    )


def _split_rank(path: str) -> Optional[int]:
    token = path.split("/", 1)[0]
    try:
        return int(token)
    except ValueError:
        return None


def get_available_entries(manifest: Manifest, rank: int) -> Manifest:
    """Merge N per-rank manifests into the view available to ``rank``.

    Manifest keys look like ``"<rank>/<logical/path>"``. Sharded entries
    union their shards across ranks; replicated entries and containers are
    visible to every rank; per-rank entries only to their owner.
    """
    grouped: Dict[str, Dict[int, Entry]] = {}
    for path, entry in manifest.items():
        owner = _split_rank(path)
        if owner is None:
            continue
        local_path = path.split("/", 1)[1] if "/" in path else ""
        grouped.setdefault(local_path, {})[owner] = entry

    available: Manifest = {}
    for local_path, by_rank in grouped.items():
        sample = next(iter(by_rank.values()))
        if isinstance(sample, ShardedArrayEntry) and sample.per_rank:
            if rank in by_rank:
                available[local_path] = by_rank[rank]
        elif isinstance(sample, ShardedArrayEntry):
            merged: Dict[Any, Shard] = {}
            for owner in sorted(by_rank):
                entry = by_rank[owner]
                for shard in entry.shards:
                    key = (tuple(shard.offsets), tuple(shard.sizes))
                    current = merged.get(key)
                    if current is None or (
                        not entry_has_content(current.array)
                        and entry_has_content(shard.array)
                    ):
                        merged[key] = shard
            available[local_path] = ShardedArrayEntry(
                dtype=sample.dtype,
                shape=sample.shape,
                shards=list(merged.values()),
                prng_impl=sample.prng_impl,
                replicated=sample.replicated,
            )
        elif is_replicated(sample):
            available[local_path] = next(
                (e for e in by_rank.values() if entry_has_content(e)),
                sample,
            )
        elif isinstance(sample, (ListEntry, DictEntry)):
            available[local_path] = by_rank.get(rank, sample)
        elif rank in by_rank:
            available[local_path] = by_rank[rank]
    return available
