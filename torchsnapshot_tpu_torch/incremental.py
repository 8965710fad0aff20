"""Incremental (deduplicated) takes, in the JAX package's format.

``Snapshot.take(path, app_state, base=prev)`` fingerprints every array
payload (on the card for a CUDA tensor: K4 of ``ops/fingerprint.py``)
and, where a leaf's content equals what ``prev`` recorded, skips both
the device→host transfer and the storage write: the manifest entry
references the base snapshot's stored object instead (an ``@base<N>/…``
location, routed by ``storage_plugin.RefRouterPlugin``). A take then
costs what changed.

Safety model, as in the JAX package:

- A fingerprint miss (none recorded, another algorithm, a changed shape
  or dtype) degrades to a full write: never corrupt, only less dedup.
- A hit needs the base entry to carry a fingerprint and a checksum,
  equal dtype, shape and PRNG impl, and, for shards, an equal region.
- Chains flatten: an entry borrowed from a base that itself borrowed it
  names the snapshot that wrote the bytes, so chains never deepen. A
  base entry whose own ``base`` index is out of range (corrupt
  metadata) degrades to a full write with a warning; the JAX package
  raises ``KeyError`` there and aborts the take.
- Back-link markers (``refs/inc_<name>``, written into the base root
  before this take commits) let ``Snapshot.delete`` on the base find the
  snapshots that still borrow from it and refuse.
"""

import asyncio
import hashlib
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .io_preparer import ArrayBufferStager
from .io_types import IOReq, WriteReq
from .manifest import ArrayEntry, Entry, Manifest, ShardedArrayEntry, SnapshotMetadata, get_available_entries
from .serialization import dtype_itemsize
from .storage_plugin import encode_base_ref, parse_ref_location, resolve_base_ref, url_to_storage_plugin

logger = logging.getLogger(__name__)

REFS_PREFIX = "refs/"


@dataclass
class IncrementalStats:
    fingerprinted: int = 0
    dedup_hits: int = 0
    dedup_bytes: int = 0


@dataclass
class _BaseContext:
    base_path: str
    metadata: SnapshotMetadata
    available: Manifest
    # Encoded refs of OUR metadata: [0] is the base itself, then the
    # base's own bases re-encoded relative to us.
    base_paths: List[str] = field(default_factory=list)
    # The base's base index -> our base_paths index (chain flattening).
    idx_map: Dict[int, int] = field(default_factory=dict)


def load_base_context(
    base_path: str, own_path: str, rank: int, metadata: Optional[SnapshotMetadata] = None
) -> _BaseContext:
    """Read the base snapshot's metadata (or reuse a handle's copy) and
    derive the reference namespace of the new take, a pure function of
    the base's metadata and the two paths, so every rank derives the same
    one without a collective. An unreadable base raises: an explicit
    ``base=`` that cannot be honoured is a configuration error."""
    if metadata is None:
        from .snapshot import _aread_metadata_at

        try:
            metadata = asyncio.run(_aread_metadata_at(base_path))
        except Exception as e:
            raise ValueError(
                f"base snapshot at {base_path!r} is unreadable ({e!r}); pass a "
                f"committed snapshot (or None for a full take)"
            ) from e
    ctx = _BaseContext(
        base_path=base_path,
        metadata=metadata,
        available=get_available_entries(metadata.manifest, rank),
        base_paths=[encode_base_ref(base_path, own_path)],
    )
    for k, ref in enumerate(metadata.base_paths):
        ours = encode_base_ref(resolve_base_ref(ref, base_path), own_path)
        if ours not in ctx.base_paths:
            ctx.base_paths.append(ours)
        ctx.idx_map[k] = ctx.base_paths.index(ours)
    return ctx


def _compute_fingerprints(write_reqs: List[WriteReq], stats: IncrementalStats) -> Dict[int, str]:
    """``{id(entry): fingerprint}`` of every array write request's
    payload. The tensors on the card are fingerprinted together, one K4
    launch per device; all results are resolved afterwards, with one
    device→host copy per device."""
    from .fingerprint import (
        fingerprint_device_async,
        fingerprint_device_many_async,
        fingerprint_host,
        resolve_fingerprints,
    )

    pending: List[Tuple[ArrayEntry, Any]] = []
    on_card: List[Tuple[ArrayEntry, torch.Tensor, Any]] = []
    fingerprints: Dict[int, str] = {}
    failed: Set[str] = set()

    def note_failure(dtype: Any, e: Exception) -> None:
        # Degrade (a full write without a fingerprint), never abort.
        if str(dtype) not in failed:
            failed.add(str(dtype))
            logger.warning(
                f"content fingerprint unavailable for dtype {dtype} ({e!r}); "
                f"affected leaves are written in full"
            )

    for wr in write_reqs:
        stager = wr.buffer_stager
        if not isinstance(stager, ArrayBufferStager):
            continue
        entry, data = stager._entry, stager._data
        if not isinstance(entry, ArrayEntry) or data is None:
            continue
        if isinstance(data, torch.Tensor) and data.is_cuda and not data.dtype.is_complex:
            on_card.append((entry, data, stager._chunk_slices))
            continue
        try:
            if isinstance(data, torch.Tensor):
                pending.append((entry, fingerprint_device_async(data, stager._chunk_slices)))
                continue
            host = np.asarray(data)
            if stager._chunk_slices is not None:
                host = host[stager._chunk_slices]
            if np.issubdtype(host.dtype, np.complexfloating):
                raise ValueError(f"no fingerprint for dtype {host.dtype}")
            fingerprints[id(entry)] = fingerprint_host(np.ascontiguousarray(host))
            stats.fingerprinted += 1
        except Exception as e:
            note_failure(getattr(data, "dtype", type(data)), e)
    if on_card:
        # On the card a kernel that fails to build or launch fails the take.
        results = fingerprint_device_many_async([(data, slices) for _, data, slices in on_card])
        pending.extend((entry, r) for (entry, _, _), r in zip(on_card, results))
    for (entry, r), res in zip(pending, resolve_fingerprints([r for _, r in pending])):
        if isinstance(res, str):
            fingerprints[id(entry)] = res
            stats.fingerprinted += 1
        elif r.is_cuda:
            raise res
        else:
            note_failure(entry.dtype, res)
    return fingerprints


def _nbytes(dtype: str, sizes: Any) -> int:
    try:
        n = dtype_itemsize(dtype)
    except TypeError:  # a size estimate only
        return 0
    for s in sizes:
        n *= s
    return n


def _rewrite_to_ref(
    entry: ArrayEntry,
    base_entry: ArrayEntry,
    ctx: _BaseContext,
    fingerprint: Optional[str],
    used_idxs: Set[int],
) -> bool:
    """Point ``entry`` at the base's stored object; False (the entry
    untouched, written in full) when the base entry names a base index
    that its metadata does not have."""
    if base_entry.base is not None:
        # Borrowed by the base: reference the original writer directly.
        our_idx = ctx.idx_map.get(base_entry.base)
        if our_idx is None:
            logger.warning(
                f"base snapshot {ctx.base_path}: {base_entry.location!r} names "
                f"base index {base_entry.base}, but its metadata records "
                f"{len(ctx.metadata.base_paths)} base path(s); writing the "
                f"leaf in full"
            )
            return False
    else:
        our_idx = 0
    # A handle's cached metadata carries decorated "@base<k>/<loc>"
    # locations; the bare location is the canonical one.
    location = base_entry.location
    parsed = parse_ref_location(location)
    if parsed is not None:
        location = parsed[1]
    entry.location = location
    entry.base = our_idx
    entry.serializer = base_entry.serializer
    entry.checksum = base_entry.checksum
    entry.compression = base_entry.compression
    entry.fingerprint = fingerprint
    used_idxs.add(our_idx)
    return True


def _dense_match(entry: ArrayEntry, base_entry: Entry, fp: Optional[str]) -> bool:
    return (
        fp is not None
        and isinstance(base_entry, ArrayEntry)
        and base_entry.fingerprint == fp
        and base_entry.checksum is not None
        # A chunk-stored base entry has no single object to borrow: the
        # chunk pass dedups it chunk by chunk instead.
        and not base_entry.chunks
        and base_entry.dtype == entry.dtype
        and list(base_entry.shape) == list(entry.shape)
        and base_entry.prng_impl == entry.prng_impl
    )


def apply_incremental(
    manifest: Manifest,
    write_reqs: List[WriteReq],
    *,
    rank: int,
    own_path: str,
    base_path: Optional[str],
    record_fingerprints: bool,
    base_metadata: Optional[SnapshotMetadata] = None,
    coordinator: Optional[Any] = None,
) -> Tuple[List[str], IncrementalStats]:
    """Fingerprint the array payloads and, given ``base_path``, dedup the
    unchanged ones against the base snapshot.

    Mutates the manifest's entries in place (the stagers hold the same
    objects) and drops deduplicated requests from ``write_reqs``; runs
    before staging, so a hit skips the device→host copy, the write and
    an async take's device clone. Returns this take's ``base_paths`` and
    the stats. With a base, one collective runs on every rank (a gather
    of the base indices used), so rank 0 alone writes the back-links."""
    stats = IncrementalStats()
    if base_path is None and not record_fingerprints:
        return [], stats
    fingerprints = _compute_fingerprints(write_reqs, stats)
    if record_fingerprints:
        # With fingerprint=False and a base, fingerprints only compare.
        for wr in write_reqs:
            entry = getattr(wr.buffer_stager, "_entry", None)
            if isinstance(entry, ArrayEntry) and id(entry) in fingerprints:
                entry.fingerprint = fingerprints[id(entry)]
    if base_path is None:
        return [], stats

    ctx = load_base_context(base_path, own_path, rank, metadata=base_metadata)
    dropped: Set[int] = set()
    used_idxs: Set[int] = set()

    def dedup(entry: ArrayEntry, base_entry: ArrayEntry, fp: str) -> None:
        if _rewrite_to_ref(entry, base_entry, ctx, fp if record_fingerprints else None, used_idxs):
            dropped.add(id(entry))
            stats.dedup_hits += 1
            stats.dedup_bytes += _nbytes(entry.dtype, entry.shape)

    for logical_path, entry in manifest.items():
        base_entry = ctx.available.get(logical_path)
        if base_entry is None:
            continue
        if isinstance(entry, ArrayEntry):
            fp = fingerprints.get(id(entry))
            if id(entry) not in dropped and _dense_match(entry, base_entry, fp):
                dedup(entry, base_entry, fp)
        elif isinstance(entry, ShardedArrayEntry) and isinstance(base_entry, ShardedArrayEntry):
            if (
                entry.dtype != base_entry.dtype
                or list(entry.shape) != list(base_entry.shape)
                or entry.prng_impl != base_entry.prng_impl
            ):
                continue
            by_region = {
                (tuple(s.offsets), tuple(s.sizes)): s.array for s in base_entry.shards
            }
            for shard in entry.shards:
                chunk = shard.array
                fp = fingerprints.get(id(chunk))
                if fp is None or id(chunk) in dropped:
                    continue
                candidate = by_region.get((tuple(shard.offsets), tuple(shard.sizes)))
                if (
                    candidate is None
                    or candidate.fingerprint != fp
                    or candidate.checksum is None
                    or candidate.chunks
                    or candidate.dtype != chunk.dtype
                ):
                    continue
                dedup(chunk, candidate, fp)

    if dropped:
        write_reqs[:] = [
            wr for wr in write_reqs if id(getattr(wr.buffer_stager, "_entry", None)) not in dropped
        ]
    # The gather is unconditional under a base: hit counts may differ
    # across ranks, collective participation may not.
    if coordinator is not None and coordinator.get_world_size() > 1:
        union: Set[int] = set()
        for idxs in coordinator.all_gather_object(sorted(used_idxs)):
            union.update(idxs)
        if rank == 0 and union:
            _write_back_link(ctx, own_path, union)
    elif used_idxs:
        _write_back_link(ctx, own_path, used_idxs)
    if stats.dedup_hits:
        logger.info(
            f"incremental take: rank {rank} deduplicated {stats.dedup_hits} "
            f"object(s) (~{stats.dedup_bytes / (1 << 20):.1f} MiB) against {base_path}"
        )
    return ctx.base_paths, stats


def _write_back_link(ctx: _BaseContext, own_path: str, used_idxs: Set[int]) -> None:
    """Durably mark each referenced base snapshot before this take can
    commit. The marker's name is a function of the referencing snapshot,
    so the write is idempotent: one marker per (base, referencer) pair,
    however many ranks and takes write it."""
    for idx in sorted(used_idxs):
        root = resolve_base_ref(ctx.base_paths[idx], own_path)
        storage = url_to_storage_plugin(root)
        try:
            child_ref = encode_base_ref(own_path, root)
            name = hashlib.sha1(child_ref.encode()).hexdigest()[:16]
            marker = IOReq(path=f"{REFS_PREFIX}inc_{name}")
            marker.buf.write(json.dumps({"path": child_ref}).encode())
            asyncio.run(storage.write(marker))
        finally:
            storage.close()
