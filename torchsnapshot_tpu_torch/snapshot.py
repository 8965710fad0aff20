"""Snapshot: take/restore of an app state of tensors, in the JAX package's
on-disk format.

``take``:
  1. capture and save the RNG stateful *first*; re-load its captured state
     after all other statefuls were saved, so their ``state_dict()`` side
     effects do not leak into the program;
  2. save the other statefuls in sorted key order: flatten each state
     dict into logical paths, stage every tensor's bytes into a private
     host buffer (a pinned one, through a D2H on a side stream, for CUDA
     tensors) and write them under a host-memory budget;
  3. write the metadata document last — the commit point: a snapshot
     without metadata is invisible.

``restore`` reads the metadata, loads the statefuls in sorted key order
and the RNG stateful last. An array restores onto the device of its
template tensor. When the template's device, dtype, shape and layout
match the stored array, the bytes are copied **into the template tensor
in place** (host→device through pinned bounce buffers), so restoring a
model onto the card holds one copy of its state there, not two; the
restored state dict then holds the template tensors themselves.

``read_object`` fetches one value (or one subtree) without a restore.

Not yet ported from the JAX package: ``async_take``, ``verify``,
``delete``, ``copy_to``, ``diff``, compression, incremental and
content-chunked takes, replicated paths and multi-rank coordination.
Snapshots using those features raise ``NotImplementedError`` where the
port cannot read them. JAX PRNG-key leaves restore as their raw uint32
key data.
"""

import asyncio
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from .coord import Coordinator, get_coordinator
from .flatten import flatten, inflate
from .io_preparer import prepare_read, prepare_write
from .io_types import IOReq, ReadReq, StoragePlugin, WriteReq, io_payload
from .manifest import (
    DictEntry,
    ListEntry,
    Manifest,
    SnapshotMetadata,
    get_available_entries,
)
from .rng_state import RNGState
from .scheduler import execute_read_reqs, execute_write_reqs, get_memory_budget_bytes
from .stateful import AppState, Stateful
from .storage_plugin import url_to_storage_plugin
from .utils.env import env_int

# The format version this package writes: the JAX package's, whose
# format it shares.
FORMAT_VERSION = "0.4.0"

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


class Snapshot:
    """A handle to a snapshot location; cheap until used."""

    def __init__(self, path: str, coord: Optional[Coordinator] = None) -> None:
        self.path = path
        self._coord = coord
        self._metadata: Optional[SnapshotMetadata] = None

    @classmethod
    def take(
        cls, path: str, app_state: AppState, coord: Optional[Coordinator] = None
    ) -> "Snapshot":
        """Persist ``app_state`` to ``path``; returns a handle. Returns
        once every payload is written and the metadata committed, so the
        caller may change its tensors afterwards."""
        coordinator = get_coordinator(coord)
        rank = coordinator.get_rank()
        app_state = dict(app_state)
        rng_key, rng_stateful = _pop_rng_state(app_state)
        manifest: Manifest = {}
        write_reqs: List[WriteReq] = []
        rng_captured = None
        if rng_stateful is not None:
            rng_captured = rng_stateful.state_dict()
            _save_stateful(rng_key, rng_captured, rank, manifest, write_reqs)
        for key in sorted(app_state):
            _save_stateful(
                key, app_state[key].state_dict(), rank, manifest, write_reqs
            )

        storage = url_to_storage_plugin(path)
        try:
            asyncio.run(
                execute_write_reqs(
                    write_reqs, storage, get_memory_budget_bytes(), rank
                )
            )
            storage.ensure_durable()
            metadata = SnapshotMetadata(
                version=FORMAT_VERSION,
                world_size=coordinator.get_world_size(),
                manifest={f"{rank}/{p}": e for p, e in manifest.items()},
                take_id=uuid.uuid4().hex,
            )
            asyncio.run(_write_metadata(storage, metadata))
        finally:
            storage.close()
        if rng_stateful is not None:
            rng_stateful.load_state_dict(rng_captured)
        snapshot = cls(path, coord)
        snapshot._metadata = metadata
        return snapshot

    def restore(self, app_state: AppState, coord: Optional[Coordinator] = None) -> None:
        """Restore ``app_state`` in place from this snapshot."""
        coordinator = get_coordinator(coord if coord is not None else self._coord)
        rank = coordinator.get_rank()
        storage = url_to_storage_plugin(self.path)
        try:
            metadata = self._read_metadata(storage)
            available = get_available_entries(metadata.manifest, rank)
            app_state = dict(app_state)
            rng_key, rng_stateful = _pop_rng_state(app_state)
            for key in sorted(app_state):
                _load_stateful(key, app_state[key], available, storage, rank)
            if rng_stateful is not None:
                _load_stateful(rng_key, rng_stateful, available, storage, rank)
        finally:
            storage.close()

    def read_object(
        self, logical_path: str, template: Any = None, rank: Optional[int] = None
    ) -> Any:
        """Fetch ONE persisted value without a full restore.

        ``logical_path`` is ``"<stateful_key>/<flattened/path>"``.
        ``template`` sets the target: a tensor's device (an array lands on
        the card for a CUDA template) or a numpy array; with None an
        array returns as a CPU tensor. A container path returns its whole
        subtree with host values."""
        if rank is None:
            rank = get_coordinator(self._coord).get_rank()
        storage = url_to_storage_plugin(self.path)
        try:
            available = get_available_entries(
                self._read_metadata(storage).manifest, rank
            )
            if logical_path not in available:
                known = [
                    p for p in sorted(available)
                    if not isinstance(available[p], (ListEntry, DictEntry))
                ]
                raise KeyError(
                    f'"{logical_path}" is not in the snapshot (for rank '
                    f"{rank}). Available leaves include: {', '.join(known[:10])}"
                )
            entry = available[logical_path]
            if not isinstance(entry, (ListEntry, DictEntry)):
                result: Dict[str, Any] = {}
                reqs, finalizers = prepare_read(
                    entry, template, lambda v: result.update(v=v)
                )
                _run_reads(reqs, finalizers, storage, rank)
                return result["v"]
            if template is not None:
                raise ValueError(
                    f'"{logical_path}" is a container; pass template=None '
                    f"(container reads return host values) or read leaves "
                    f"individually."
                )
            prefix = logical_path + "/"
            containers: Manifest = {}
            flattened: Dict[str, Any] = {}
            reqs: List[ReadReq] = []
            finalizers: List[Callable[[], None]] = []
            for p, e in available.items():
                if p != logical_path and not p.startswith(prefix):
                    continue
                if isinstance(e, (ListEntry, DictEntry)):
                    containers[p] = e
                    continue

                def _cb(value: Any, p: str = p) -> None:
                    flattened[p] = value

                r, f = prepare_read(e, None, _cb)
                reqs.extend(r)
                finalizers.extend(f)
            _run_reads(reqs, finalizers, storage, rank)
            return inflate(containers, flattened, prefix=logical_path)
        finally:
            storage.close()

    def get_manifest(self) -> Manifest:
        """The merged manifest of all ranks (inspection API)."""
        storage = url_to_storage_plugin(self.path)
        try:
            return dict(self._read_metadata(storage).manifest)
        finally:
            storage.close()

    def _read_metadata(self, storage: StoragePlugin) -> SnapshotMetadata:
        if self._metadata is None:
            io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
            asyncio.run(storage.read(io_req))
            self._metadata = SnapshotMetadata.from_yaml(
                _decode_metadata_doc(bytes(io_payload(io_req)))
            )
        return self._metadata


def _pop_rng_state(
    app_state: Dict[str, Stateful]
) -> Tuple[str, Optional[RNGState]]:
    """Extract the (at most one) RNGState."""
    rng_items = [
        (key, stateful)
        for key, stateful in app_state.items()
        if isinstance(stateful, RNGState)
    ]
    if len(rng_items) > 1:
        raise RuntimeError(
            f"An app_state can have at most one RNGState; got {len(rng_items)}."
        )
    if not rng_items:
        return "", None
    key, stateful = rng_items[0]
    del app_state[key]
    return key, stateful


def _save_stateful(
    key: str,
    state_dict: Dict[str, Any],
    rank: int,
    manifest_out: Manifest,
    write_reqs_out: List[WriteReq],
) -> None:
    container_manifest, flattened = flatten(state_dict, prefix=key)
    manifest_out.update(container_manifest)
    for logical_path, value in sorted(flattened.items()):
        entry, write_reqs = prepare_write(value, logical_path, rank)
        manifest_out[logical_path] = entry
        write_reqs_out.extend(write_reqs)


def _run_reads(
    reqs: List[ReadReq],
    finalizers: List[Callable[[], None]],
    storage: StoragePlugin,
    rank: int,
) -> None:
    asyncio.run(execute_read_reqs(reqs, storage, get_memory_budget_bytes(), rank))
    for finalize in finalizers:
        finalize()


def _load_stateful(
    key: str,
    stateful: Stateful,
    available: Manifest,
    storage: StoragePlugin,
    rank: int,
) -> None:
    # The template state dict supplies the devices, dtypes and shapes the
    # restored values land in (and, when they match, the tensors).
    container_manifest, flattened = flatten(stateful.state_dict(), prefix=key)
    # The RNG streams torch adds (torch/CUDA generator states) are absent
    # from a JAX-package snapshot; they then keep their current state.
    optional = isinstance(stateful, RNGState)
    reqs: List[ReadReq] = []
    finalizers: List[Callable[[], None]] = []
    for logical_path, template in list(flattened.items()):
        if logical_path not in available:
            if optional:
                del flattened[logical_path]
                continue
            raise RuntimeError(
                f'Unable to find an entry for "{logical_path}" for rank '
                f"{rank} in the snapshot."
            )

        def _callback(value: Any, p: str = logical_path) -> None:
            flattened[p] = value

        r, f = prepare_read(available[logical_path], template, _callback)
        reqs.extend(r)
        finalizers.extend(f)
    _run_reads(reqs, finalizers, storage, rank)

    # Prefer the snapshot's container entries so saved structure (dict key
    # sets) round-trips; fall back to the template's for the rest.
    inflate_manifest: Manifest = {
        p: e
        for p, e in container_manifest.items()
        if not optional or p in available
    }
    inflate_manifest.update(
        {
            p: e
            for p, e in available.items()
            if isinstance(e, (ListEntry, DictEntry))
            and (p == key or p.startswith(key + "/"))
        }
    )
    stateful.load_state_dict(inflate(inflate_manifest, flattened, prefix=key))


def _encode_metadata_doc(doc: str) -> bytes:
    """The metadata document's bytes: zlib-compressed from 1 MiB on
    (``TPUSNAPSHOT_METADATA_COMPRESS_THRESHOLD``), as the JAX package
    writes it."""
    raw = doc.encode("utf-8")
    if len(raw) >= env_int("TPUSNAPSHOT_METADATA_COMPRESS_THRESHOLD", 1 << 20):
        return zlib.compress(raw, 1)
    return raw


def _decode_metadata_doc(data: bytes) -> str:
    # A zlib stream begins 0x78; the document itself begins '{' (JSON)
    # or a letter (YAML), so the formats cannot collide.
    if data[:1] == b"\x78":
        data = zlib.decompress(data)
    return data.decode("utf-8")


async def _write_metadata(storage: StoragePlugin, metadata: SnapshotMetadata) -> None:
    io_req = IOReq(path=SNAPSHOT_METADATA_FNAME)
    io_req.buf.write(_encode_metadata_doc(metadata.to_yaml()))
    await storage.write(io_req)
