"""Write-side reference-format interop: export a native snapshot as a
snapshot the **reference** torchsnapshot restores.

The port of ``torchsnapshot_tpu/interop/reference_writer.py``, so a
migration is reversible. The format written (all cited from the
reference):

- ``.snapshot_metadata``: ``{version, world_size, manifest}``
  (manifest.py:111-118) with entry dicts as the reference's
  ``SnapshotMetadata.from_yaml`` reconstructs them (manifest.py:120-154),
  written with ``yaml.dump`` where PyYAML imports and otherwise as JSON,
  which every YAML loader (the reference's included) reads;
- one ``torch.save`` blob per leaf (io_preparer.py:218, 279) under the
  reference's locations ``<rank>/…`` and ``replicated/…``
  (io_preparer.py:336-342); the serializer is always ``"torch_save"``.

Mapping, lossy in documented ways, as in the JAX package:

- sharded arrays are assembled dense and written as replicated Tensor
  entries (the reference's ShardedTensor restore needs a live
  ShardedTensor in the target, which an app migrating back lacks);
- tuples are written as lists (the reference has no tuple entry);
- primitive entries become object entries with ``torch.save`` payloads;
- arrays are written as the torch tensors the native restore gives, so
  bfloat16 and float8 need no ``ml_dtypes``; JAX PRNG keys as their raw
  uint32 key data.

Collective-free and single-process: run it from one rank or offline.
Values go through host memory one at a time: the peak is about the
largest leaf plus the dense size of the largest sharded array.
"""

import asyncio
import io
import json
import logging
from typing import Any, Dict, Tuple

import torch

from ..io_types import IOReq
from ..manifest import (
    ArrayEntry,
    DictEntry,
    ListEntry,
    ObjectEntry,
    OrderedDictEntry,
    PrimitiveEntry,
    ShardedArrayEntry,
    get_available_entries,
)
from ..io_preparer import prepare_read
from ..scheduler import execute_read_reqs, get_memory_budget_bytes
from ..storage_plugin import url_to_storage_plugin

logger = logging.getLogger(__name__)

_METADATA_FNAME = ".snapshot_metadata"
_REFERENCE_VERSION = "0.0.3"  # reference version.py:17


def _torch_save_bytes(obj: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _dump_metadata(doc: Dict[str, Any]) -> str:
    try:
        import yaml
    except ImportError:
        return json.dumps(doc)
    return yaml.dump(doc, sort_keys=False)


def _location(logical: str, rank: int, replicated: bool) -> str:
    return f"replicated/{logical}" if replicated else f"{rank}/{logical}"


def _reference_entry(entry: Any, logical: str, rank: int) -> Tuple[Dict[str, Any], bool]:
    """The reference's entry dict for a native entry, and whether it has
    a payload to write; (None, False) for an entry type it cannot hold."""
    if isinstance(entry, ListEntry):  # TupleEntry too: written as a list
        return {"type": "list"}, False
    if isinstance(entry, OrderedDictEntry):
        return {"type": "OrderedDict", "keys": list(entry.keys)}, False
    if isinstance(entry, DictEntry):
        return {"type": "dict", "keys": list(entry.keys)}, False
    if isinstance(entry, (PrimitiveEntry, ObjectEntry)):
        replicated = bool(entry.replicated)
        return {
            "type": "object",
            "location": _location(logical, rank, replicated),
            "serializer": "torch_save",
            "obj_type": entry.ptype if isinstance(entry, PrimitiveEntry) else "object",
            "replicated": replicated,
        }, True
    if isinstance(entry, (ArrayEntry, ShardedArrayEntry)):
        # A sharded array is assembled dense, visible to every rank.
        replicated = isinstance(entry, ShardedArrayEntry) or bool(entry.replicated)
        return {
            "type": "Tensor",
            "location": _location(logical, rank, replicated),
            "serializer": "torch_save",
            "dtype": None,  # set from the tensor the payload holds
            "shape": [int(s) for s in entry.shape],
            "replicated": replicated,
        }, True
    return None, False


def convert_back(native_path: str, dest_path: str) -> None:
    """Export the native snapshot at ``native_path`` (either package's,
    incremental and chunked ones included) to a reference-torchsnapshot
    snapshot at ``dest_path``."""
    from ..snapshot import Snapshot

    # _open_storage routes the "@base<N>/…" locations of an incremental or
    # chunked snapshot to their roots, so the export stands alone.
    src = Snapshot(native_path)
    storage_in = src._open_storage()
    storage_out = url_to_storage_plugin(dest_path)
    budget = get_memory_budget_bytes()
    try:
        metadata = src._read_metadata(storage_in)
        ref_manifest: Dict[str, Dict[str, Any]] = {}
        # location -> native entry: each payload is read and written once,
        # though a replicated or sharded entry appears under every rank.
        pending: Dict[str, Any] = {}
        for rank in range(metadata.world_size):
            for logical, entry in sorted(get_available_entries(metadata.manifest, rank).items()):
                full = f"{rank}/{logical}"
                ref_entry, has_payload = _reference_entry(entry, logical, rank)
                if ref_entry is None:
                    logger.warning(
                        f"convert_back: skipping {full} (unmapped entry type "
                        f"{type(entry).__name__})"
                    )
                    continue
                ref_manifest[full] = ref_entry
                if has_payload:
                    pending.setdefault(ref_entry["location"], entry)

        dtypes_by_loc: Dict[str, str] = {}

        async def _convert_payloads() -> None:
            # One leaf at a time, under one event loop.
            for loc, entry in sorted(pending.items()):
                if isinstance(entry, PrimitiveEntry):
                    value = entry.get_value()
                else:
                    holder: Dict[str, Any] = {}
                    reqs, plans = prepare_read(entry, None, lambda v: holder.update(v=v))
                    try:
                        await execute_read_reqs(reqs, storage_in, budget, rank=0)
                        for plan in plans:
                            plan.await_pipeline()
                    except BaseException:
                        for plan in plans:
                            plan.settle()
                        raise
                    for plan in plans:
                        plan.finalize()
                    value = holder["v"]
                    if isinstance(value, torch.Tensor):
                        dtypes_by_loc[loc] = str(value.dtype)  # the reference's name, "torch.float32"
                await storage_out.write(IOReq(path=loc, data=_torch_save_bytes(value)))
            for ref_entry in ref_manifest.values():
                if ref_entry["type"] == "Tensor":
                    ref_entry["dtype"] = dtypes_by_loc[ref_entry["location"]]
            doc = _dump_metadata({
                "version": _REFERENCE_VERSION,
                "world_size": metadata.world_size,
                "manifest": ref_manifest,
            })
            await storage_out.write(IOReq(path=_METADATA_FNAME, data=doc.encode("utf-8")))

        asyncio.run(_convert_payloads())
    finally:
        storage_in.close()
        storage_out.close()
